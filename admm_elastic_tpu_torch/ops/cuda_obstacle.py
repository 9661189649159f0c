"""Wrapper of kernel J (``csrc/obstacle.cu``): one mesh obstacle's detection
in one launch, in place of the JAX package's jnp narrow phases
(``admm_elastic_tpu/collision/passive.py:120-179`` and ``:401-546``), which
have no Pallas kernel.

``mesh_detect(obs, x, overflow, blocks=None)`` returns (dx [V], point [V, 3],
normal [V, 3], mask [V]) of the mesh obstacle ``obs`` (``PassiveMeshSDF`` or
``PassiveMeshExact``, on x's device in x's dtype) at the query lanes x
[V, 3], and sets ``overflow`` (an int32 tensor of one element on x's
device) to 1 where its near-lane compaction or its deep fallback dropped a
lane; it never clears it. Dispatch is by the tensors' device: CPU tensors
take the plain version (the obstacle's own ``signed_distance_with_overflow``);
CUDA tensors launch the kernel, and a build or launch failure raises.
``mesh_detect.launches`` counts kernel launches.

The kernel runs as a cooperative grid of persistent blocks of 512 threads
(``j_grid``: one a SM, and at most one a 16 lanes); a launch that the
runtime refuses raises. Its grid barrier is one zeroed buffer per device,
allocated on the first call, which must come before any capture (the
solver's warm-up step makes it); each launch leaves it as it found it.
``blocks`` caps the grid, for measurements and tests; it changes no bit of
the result.

``mesh_detect_scenes(obs, x, overflow)`` is J's scene form
(scenario batching, ``parallel/batch.py``): x [S, V, 3], outputs [S, V, ...]
and overflow int32 [S], each scene compacted and served by the deep fallback
on its own, scene i bit for bit ``mesh_detect`` on x[i]; one cooperative
launch of teams of blocks (``cuda_uzawa.scene_teams``: a team a scene up to
the blocks the card holds at once, each team on its own barrier taking its
scenes in turn, its scratch its own), so any S runs. Its twin is the
obstacle's ``signed_distance_with_overflow(x, scenes=True)``.

``mesh_desc`` describes a mesh obstacle to kernel J and to kernel H's sweeps
(``ops/cuda_gs.py``): its sizes and the device addresses of its tables, read
without a synchronisation, so a captured step passes the same addresses the
obstacle keeps.
"""

from __future__ import annotations

import ctypes

import torch

from admm_elastic_tpu_torch.collision.passive import PassiveMeshExact, PassiveMeshSDF
from admm_elastic_tpu_torch.ops import _build

MESH_SDF, MESH_EXACT = 2, 3  # csrc/obstacle_body.cuh enum MeshKind
MESH_INTS, MESH_PTRS = 10, 9  # csrc/obstacle_body.cuh kMeshInts, kMeshPtrs
J_THREADS = 512  # csrc/obstacle.cu kThreads
LANES_PER_BLOCK = J_THREADS // 32  # the fewest lanes a block takes: a warp each
BARRIER_INTS = 64  # csrc/grid_sync.cuh struct Barrier, rounded up


def j_grid(v: int, most: int, cap=None) -> int:
    """The blocks of kernel J for v lanes: at most most (one a SM, where the
    card holds one: max_blocks), one a LANES_PER_BLOCK lanes and cap."""
    grid = min(most, -(-v // LANES_PER_BLOCK))
    return max(1, grid if cap is None else min(grid, cap))


def j_span(n: int, grid: int) -> int:
    """The lanes (or list entries) of n that each block of a grid owns, in
    order (csrc/obstacle.cu): block b takes [b span, (b + 1) span)."""
    return -(-n // grid)


def j_group(per: int, threads: int = J_THREADS, kf: int = 32) -> int:
    """The threads that walk one entry's candidates where a block of threads
    owns per entries of a table whose rows hold kf (csrc/obstacle_body.cuh
    group_size; kernel J's block, and kernel H's pass with its own block and
    count): the largest power of two <= 32 with g per <= threads and g <= kf."""
    g = 32
    while g > 1 and (g * per > threads or g > kf):
        g //= 2
    return g


def _check(name, t, device, dtype, shape=None):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or (
            shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"mesh obstacle: {name} must be a contiguous {dtype} tensor"
                         f"{'' if shape is None else f' of shape {tuple(shape)}'} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def mesh_desc(obs, device, dtype):
    """(ints [MESH_INTS], pointers [MESH_PTRS], capture_cells) of a mesh
    obstacle whose tensors lie on device in dtype (the solver's obs.to): kind,
    dims, near_lanes, kf, table16, n_tris, fallback_lanes, n_nodes; origin, h,
    vals4, minv, tri_abc, nrm, face_table, face_count, tet_count (0 where the
    kind has none)."""
    _check("origin", obs.origin, device, dtype, (3,))
    _check("h", obs.h, device, dtype, ())
    g = obs.dims[0] * obs.dims[1] * obs.dims[2]
    if isinstance(obs, PassiveMeshSDF):
        _check("vals4", obs.vals4, device, dtype, (g, 4))
        _check("minv", obs.minv, device, torch.float64, (g,))
        ints = [MESH_SDF, *obs.dims, obs.near_lanes, 0, 0, 0, 0, g]
        ptrs = [obs.origin, obs.h, obs.vals4, obs.minv] + [None] * 5
        return ints, ptrs, 0.0
    if isinstance(obs, PassiveMeshExact):
        f = obs.tri_abc.shape[0]
        _check("tri_abc", obs.tri_abc, device, dtype, (f, 3, 3))
        _check("nrm", obs.nrm, device, dtype, (f, 7, 3))
        table16 = obs.face_table.dtype == torch.int16
        _check("face_table", obs.face_table, device, torch.int16 if table16 else torch.int32,
               (g, obs.face_table.shape[1]))
        _check("face_count", obs.face_count, device, torch.int32, (g,))
        _check("tet_count", obs.tet_count, device, torch.int8, (g,))
        ints = [MESH_EXACT, *obs.dims, obs.near_lanes, obs.face_table.shape[1], int(table16), f,
                obs.fallback_lanes, g]
        ptrs = [obs.origin, obs.h, None, None, obs.tri_abc, obs.nrm, obs.face_table,
                obs.face_count, obs.tet_count]
        return ints, ptrs, float(obs.capture_cells)
    raise TypeError(f"mesh_detect: {type(obs).__name__} is not a mesh obstacle")


def addresses(tensors):
    """The device addresses of tensors (0 for None)."""
    return [0 if t is None else t.data_ptr() for t in tensors]


def mesh_detect(obs, x: torch.Tensor, overflow: torch.Tensor, blocks=None):
    """(dx, point, normal, mask) of mesh obstacle obs at x [V, 3]; its
    overflow set in overflow (int32 [1]); blocks caps kernel J's grid."""
    if x.device.type == "cpu":
        dx, point, normal, ovf = obs.signed_distance_with_overflow(x)
        overflow |= ovf.to(overflow.dtype)
        return dx, point, normal, dx < 0.0
    out = _launch(obs, x, overflow, blocks)
    mesh_detect.launches += 1
    return out


_MAX_BLOCKS: dict = {}  # (device, dtype) -> the most blocks of kernel J a launch takes
_BARRIERS: dict = {}  # device -> kernel J's grid barrier


def max_blocks(device, dtype) -> int:
    """The most blocks of kernel J a launch takes on the card: one a SM
    (read once)."""
    key = (device, dtype)
    if key not in _MAX_BLOCKS:
        with torch.cuda.device(device):
            n = int(_build.library().admm_mesh_blocks(int(dtype == torch.float64)))
        if n <= 0:
            raise RuntimeError(f"mesh_detect: the card holds no block of kernel J "
                               f"(cudaError {-n})")
        _MAX_BLOCKS[key] = n
    return _MAX_BLOCKS[key]


def _barrier(device):
    if device not in _BARRIERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("mesh_detect: call it once on this device before a capture "
                               "(its grid barrier is allocated on the first call)")
        _BARRIERS[device] = torch.zeros((BARRIER_INTS,), dtype=torch.int32, device=device)
    return _BARRIERS[device]


def _launch(obs, x, overflow, blocks=None):
    v = x.shape[0]
    sfx = _build.cuda_args("mesh_detect", x, (("x", x, (v, 3)),))
    _check("overflow", overflow, x.device, torch.int32, (1,))
    ints, ptrs, capture = mesh_desc(obs, x.device, x.dtype)
    grid = j_grid(v, max_blocks(x.device, x.dtype), blocks)
    dx = torch.empty((v,), dtype=x.dtype, device=x.device)
    point = torch.empty_like(x)
    normal = torch.empty_like(x)
    mask = torch.empty((v,), dtype=torch.bool, device=x.device)
    k_fb = max(getattr(obs, "fallback_lanes", 0), 1)
    scratch = torch.empty((3 * v + 2 * grid + k_fb,), dtype=torch.int32, device=x.device)
    lists = [scratch[:v], scratch[v:2 * v], scratch[2 * v:3 * v],
             scratch[3 * v:3 * v + 2 * grid], scratch[3 * v + 2 * grid:]]
    ptr_arr = (ctypes.c_uint64 * (MESH_PTRS + 12))(*addresses(
        ptrs + [x, dx, point, normal, mask, overflow] + lists + [_barrier(x.device)]))
    int_arr = (ctypes.c_int * (MESH_INTS + 4))(*ints, v, grid, -1, 0)
    fn = getattr(_build.library(), f"admm_mesh_detect_{sfx}")
    with torch.cuda.device(x.device):
        rc = fn(ptr_arr, int_arr, capture, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "mesh_detect")
    return dx, point, normal, mask


def mesh_detect_scenes(obs, x: torch.Tensor, overflow: torch.Tensor):
    """Kernel J's scene form: (dx [S, V], point, normal [S, V, 3], mask
    [S, V]) of mesh obstacle obs at S scenes' query lanes x [S, V, 3], each
    scene compacted and served by the fallback on its own, its overflow set in
    overflow[i] (int32 [S]); one cooperative launch of teams of blocks
    (cuda_uzawa.scene_teams), scene i bit for bit
    mesh_detect on x[i]. Twin: the obstacle's signed_distance_with_overflow(x,
    scenes=True)."""
    if x.device.type == "cpu":
        dx, point, normal, ovf = obs.signed_distance_with_overflow(x, scenes=True)
        overflow |= ovf.to(overflow.dtype)
        return dx, point, normal, dx < 0.0
    from admm_elastic_tpu_torch.ops.cuda_uzawa import scene_teams

    s_cnt, v = int(x.shape[0]), int(x.shape[1])
    sfx = _build.cuda_args("mesh_detect_scenes", x, (("x", x, (s_cnt, v, 3)),))
    _check("overflow", overflow, x.device, torch.int32, (s_cnt,))
    ints, ptrs, capture = mesh_desc(obs, x.device, x.dtype)
    most = scene_max_blocks(x.device, x.dtype)
    teams, bps = scene_teams(s_cnt, j_grid(v, most), most)
    dx = torch.empty((s_cnt, v), dtype=x.dtype, device=x.device)
    point = torch.empty_like(x)
    normal = torch.empty_like(x)
    mask = torch.empty((s_cnt, v), dtype=torch.bool, device=x.device)
    k_fb = max(getattr(obs, "fallback_lanes", 0), 1)
    lists = [torch.empty((teams, v), dtype=torch.int32, device=x.device) for _ in range(3)]
    lists += [torch.empty((teams, 2 * bps), dtype=torch.int32, device=x.device),
              torch.empty((teams, k_fb), dtype=torch.int32, device=x.device)]
    ptr_arr = (ctypes.c_uint64 * (MESH_PTRS + 12))(*addresses(
        ptrs + [x, dx, point, normal, mask, overflow] + lists
        + [_scene_barriers(x.device)[:teams * BARRIER_INTS]]))
    int_arr = (ctypes.c_int * (MESH_INTS + 4))(*ints, v, teams * bps, s_cnt, teams)
    fn = getattr(_build.library(), f"admm_mesh_detect_{sfx}")
    with torch.cuda.device(x.device):
        rc = fn(ptr_arr, int_arr, capture, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "mesh_detect_scenes")
    mesh_detect_scenes.launches += 1
    return dx, point, normal, mask


_SCENE_BLOCKS: dict = {}  # (device, dtype) -> the most blocks of J's scene form at once
_SCENE_BARRIERS: dict = {}  # device -> J's scene form's team barriers


def scene_max_blocks(device, dtype) -> int:
    """The most blocks of kernel J's scene form a launch takes: one a SM
    (read once)."""
    key = (device, dtype)
    if key not in _SCENE_BLOCKS:
        with torch.cuda.device(device):
            n = int(_build.library().admm_mesh_scene_blocks(int(dtype == torch.float64)))
        if n <= 0:
            raise RuntimeError(f"mesh_detect_scenes: the card holds no block of kernel J's scene "
                               f"form (cudaError {-n})")
        _SCENE_BLOCKS[key] = n
    return _SCENE_BLOCKS[key]


def _scene_barriers(device):
    """J's scene form's team barriers, as many as its grid can have teams:
    one zeroed buffer a device, allocated on the first call, outside any
    capture; each launch leaves it as it found it."""
    if device not in _SCENE_BARRIERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("mesh_detect_scenes: call it once on this device before a "
                               "capture (its team barriers are allocated on the first call)")
        most = max(scene_max_blocks(device, torch.float32),
                   scene_max_blocks(device, torch.float64))
        _SCENE_BARRIERS[device] = torch.zeros((most * BARRIER_INTS,), dtype=torch.int32,
                                              device=device)
    return _SCENE_BARRIERS[device]


mesh_detect.launches = 0
mesh_detect_scenes.launches = 0
