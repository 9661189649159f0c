"""The six demo apps of the JAX package's ``apps/``, on this package.

Each runs as ``python -m admm_elastic_tpu_torch.apps.<name> [flags]`` (beams,
trianglestrain, bunnyexpand, signorini, torus, boxes), on the card unless
``--cpu`` is given; ``_app.py`` is their shell.
"""
