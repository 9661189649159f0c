"""Scale-out: scenario batching of one mesh's scenes on one card (parallel/batch.py)."""
