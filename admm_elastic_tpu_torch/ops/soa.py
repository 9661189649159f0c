"""Structure-of-arrays 3x3 algebra and the signed SVD, in PyTorch.

A port of ``admm_elastic_tpu/ops/soa.py:23-376``. Matrices are 9-tuples
of same-shape tensors in row-major entry order, vectors 3-tuples; a 3x2
cloth deformation gradient is a 6-tuple (F00, F01, F10, F11, F20, F21).
Every function performs the same operations in the same order as its JAX
counterpart: these are the plain versions of the bodies of kernels A, D
and F (``csrc/local_step.cu``) and E (``csrc/tri_local_step.cu``), which
repeat them line for line.

Two JAX semantics that PyTorch does not share are written out:
``torch.sign(nan)`` is 0 where ``jnp.sign(nan)`` is NaN (``_sign``), and
every max goes through ``torch.clamp`` / ``torch.maximum``, which
propagate NaN as ``jnp.maximum`` does.
"""

from __future__ import annotations

import torch


def _sign(x):
    """jnp.sign: -1, 0 or 1, and NaN for NaN."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, x))


# --- small algebra ------------------------------------------------------------

def matmul33(a, b):
    (a11, a12, a13, a21, a22, a23, a31, a32, a33) = a
    (b11, b12, b13, b21, b22, b23, b31, b32, b33) = b
    return (
        a11 * b11 + a12 * b21 + a13 * b31,
        a11 * b12 + a12 * b22 + a13 * b32,
        a11 * b13 + a12 * b23 + a13 * b33,
        a21 * b11 + a22 * b21 + a23 * b31,
        a21 * b12 + a22 * b22 + a23 * b32,
        a21 * b13 + a22 * b23 + a23 * b33,
        a31 * b11 + a32 * b21 + a33 * b31,
        a31 * b12 + a32 * b22 + a33 * b32,
        a31 * b13 + a32 * b23 + a33 * b33,
    )


def transpose33(a):
    (a11, a12, a13, a21, a22, a23, a31, a32, a33) = a
    return (a11, a21, a31, a12, a22, a32, a13, a23, a33)


def matmul33_nt(a, b):
    """a @ b^T."""
    return matmul33(a, transpose33(b))


def matmul33_tn(a, b):
    """a^T @ b."""
    return matmul33(transpose33(a), b)


def det3_soa(a):
    (a11, a12, a13, a21, a22, a23, a31, a32, a33) = a
    return (
        a11 * (a22 * a33 - a23 * a32)
        - a12 * (a21 * a33 - a23 * a31)
        + a13 * (a21 * a32 - a22 * a31)
    )


def cross3(u, v):
    return (
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    )


def dot3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


# --- [..., 3, 3] determinant and inverse ----------------------------------------
# A copy of admm_elastic_tpu/ops/svd3.py det3 / inv3 (:34-55), the closed forms,
# on [..., 3, 3] tensors, every sum written out in component order: the plain
# version of kernel K's per-tet frames (csrc/self_collision.cu).

def _cross_rows(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def det3(m):
    """The determinant r0 . (r1 x r2) of each 3x3 (rows r0, r1, r2)."""
    c = _cross_rows(m[..., 1, :], m[..., 2, :])
    r0 = m[..., 0, :]
    return (r0[..., 0] * c[..., 0] + r0[..., 1] * c[..., 1]) + r0[..., 2] * c[..., 2]


def inv3(m):
    """The inverse of each 3x3 by the adjugate: column j is the cross product
    of the rows other than j, over det3 (1 where |det| < 1e-300 in the
    dtype: never in float32, where it rounds to 0)."""
    d = det3(m)
    tiny = torch.tensor(1e-300, dtype=d.dtype, device=d.device)
    safe = torch.where(torch.abs(d) < tiny, 1.0, d)
    c0 = _cross_rows(m[..., 1, :], m[..., 2, :])
    c1 = _cross_rows(m[..., 2, :], m[..., 0, :])
    c2 = _cross_rows(m[..., 0, :], m[..., 1, :])
    return torch.stack([c0, c1, c2], dim=-1) / safe[..., None, None]


def col(a, j):
    return (a[j], a[3 + j], a[6 + j])


def from_cols(c0, c1, c2):
    return (c0[0], c1[0], c2[0], c0[1], c1[1], c2[1], c0[2], c1[2], c2[2])


# --- Jacobi eigendecomposition of symmetric 3x3 -----------------------------------

def _rot_pq(s6, V, p, q):
    """One Jacobi rotation zeroing the (p,q) entry; s6 = (a11, a22, a33,
    a12, a13, a23), V a 9-tuple whose columns are eigenvector estimates."""
    a11, a22, a33, a12, a13, a23 = s6
    diag = {0: a11, 1: a22, 2: a33}
    off = {(0, 1): a12, (0, 2): a13, (1, 2): a23}

    apq = off[(p, q)]
    app = diag[p]
    aqq = diag[q]
    zero = apq == 0.0
    theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
    theta = torch.clamp(theta, -1e15, 1e15)
    t = _sign(theta) / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
    t = torch.where(zero, 0.0, t)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c

    r = 3 - p - q  # the untouched index
    arp = off[(min(r, p), max(r, p))]
    arq = off[(min(r, q), max(r, q))]

    new_pp = c * c * app - 2.0 * s * c * apq + s * s * aqq
    new_qq = s * s * app + 2.0 * s * c * apq + c * c * aqq
    new_rp = c * arp - s * arq
    new_rq = s * arp + c * arq

    diag[p] = new_pp
    diag[q] = new_qq
    off[(p, q)] = torch.zeros_like(apq)
    off[(min(r, p), max(r, p))] = new_rp
    off[(min(r, q), max(r, q))] = new_rq
    s6_new = (diag[0], diag[1], diag[2], off[(0, 1)], off[(0, 2)], off[(1, 2)])

    vp = col(V, p)
    vq = col(V, q)
    new_vp = tuple(c * a - s * b for a, b in zip(vp, vq))
    new_vq = tuple(s * a + c * b for a, b in zip(vp, vq))
    cols = [col(V, 0), col(V, 1), col(V, 2)]
    cols[p] = new_vp
    cols[q] = new_vq
    return s6_new, from_cols(*cols)


def jacobi_eigh3_soa(s6, sweeps: int):
    """Eigendecomposition of symmetric 3x3 in SoA form -> (V, w)."""
    one = torch.ones_like(s6[0])
    zero = torch.zeros_like(s6[0])
    V = (one, zero, zero, zero, one, zero, zero, zero, one)
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            s6, V = _rot_pq(s6, V, p, q)
    return V, (s6[0], s6[1], s6[2])


def signed_svd3_soa(f, sweeps: int = 8):
    """Branch-free signed SVD: f 9-tuple -> (U, S, V), det(U), det(V) > 0,
    inversion sign on S[2], singular values sorted descending."""
    dtype = f[0].dtype
    eps = torch.tensor(1e-12 if dtype == torch.float64 else 1e-8, dtype=dtype,
                       device=f[0].device)

    ftf = matmul33_tn(f, f)
    s6 = (ftf[0], ftf[4], ftf[8], ftf[1], ftf[2], ftf[5])
    V, w = jacobi_eigh3_soa(s6, sweeps)

    def swap(V, w, i, j):
        cond = w[i] < w[j]
        wl = list(w)
        wl[i] = torch.where(cond, w[j], w[i])
        wl[j] = torch.where(cond, w[i], w[j])
        cols = [col(V, 0), col(V, 1), col(V, 2)]
        ci = tuple(torch.where(cond, b, a) for a, b in zip(cols[i], cols[j]))
        cj = tuple(torch.where(cond, a, b) for a, b in zip(cols[i], cols[j]))
        cols[i], cols[j] = ci, cj
        return from_cols(*cols), tuple(wl)

    V, w = swap(V, w, 0, 1)
    V, w = swap(V, w, 0, 2)
    V, w = swap(V, w, 1, 2)

    S = tuple(torch.sqrt(torch.clamp(wi, min=0.0)) for wi in w)

    # U = F V / S with orthonormalization fallbacks.
    fv = matmul33(f, V)
    u0 = tuple(fv[3 * r] / torch.maximum(S[0], eps) for r in range(3))
    u1 = tuple(fv[3 * r + 1] / torch.maximum(S[1], eps) for r in range(3))

    n0 = torch.sqrt(dot3(u0, u0))
    ok0 = n0 > eps
    inv0 = 1.0 / torch.maximum(n0, eps)
    e0 = (torch.ones_like(n0), torch.zeros_like(n0), torch.zeros_like(n0))
    u0 = tuple(torch.where(ok0, a * inv0, e) for a, e in zip(u0, e0))

    proj = dot3(u1, u0)
    u1 = tuple(a - proj * b for a, b in zip(u1, u0))
    n1 = torch.sqrt(dot3(u1, u1))
    ok1 = n1 > eps
    inv1 = 1.0 / torch.maximum(n1, eps)
    big0 = torch.abs(u0[0]) > 0.9
    alt_ref = (
        torch.where(big0, 0.0, 1.0).to(dtype),
        torch.where(big0, 1.0, 0.0).to(dtype),
        torch.zeros_like(n1),
    )
    alt = cross3(u0, alt_ref)
    altn = torch.sqrt(torch.maximum(dot3(alt, alt), eps * eps))
    alt = tuple(a / altn for a in alt)
    u1 = tuple(torch.where(ok1, a * inv1, b) for a, b in zip(u1, alt))
    u2 = cross3(u0, u1)
    U = from_cols(u0, u1, u2)

    detV = det3_soa(V)
    flipV = torch.where(detV < 0.0, -1.0, 1.0).to(dtype)
    cols = [col(V, 0), col(V, 1), tuple(flipV * a for a in col(V, 2))]
    V = from_cols(*cols)

    detF = det3_soa(f)
    S = (S[0], S[1], S[2] * torch.where(detF < 0.0, -1.0, 1.0).to(dtype))
    return U, S, V


def compose_usv(U, S, V):
    """U @ diag(S) @ V^T in SoA form."""
    US = from_cols(
        tuple(S[0] * a for a in col(U, 0)),
        tuple(S[1] * a for a in col(U, 1)),
        tuple(S[2] * a for a in col(U, 2)),
    )
    return matmul33_nt(US, V)


def solve3x3_sym_soa(h6, g):
    """Solve symmetric 3x3 systems: h6=(h11,h22,h33,h12,h13,h23), g vec3.

    The singular-det guard is 1e-300 in the array's dtype, as in JAX: in
    float32 it rounds to 0 and never fires."""
    a, d, f2, b, c, e = h6
    A = d * f2 - e * e
    B = c * e - b * f2
    C = b * e - c * d
    D = a * f2 - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    tiny = torch.tensor(1e-300, dtype=det.dtype, device=det.device)
    inv = 1.0 / torch.where(torch.abs(det) < tiny, 1.0, det)
    return (
        (A * g[0] + B * g[1] + C * g[2]) * inv,
        (B * g[0] + D * g[1] + E * g[2]) * inv,
        (C * g[0] + E * g[1] + F * g[2]) * inv,
    ), det


# --- prox bodies on tuples ---------------------------------------------------------

def prox_tet_linear_tuple(f, sweeps: int = 8):
    """Linear-tet prox 1/2 (U V^T + F) on a 9-tuple (plain version of kernel F
    and of the linear variant of kernel A)."""
    U, _, V = signed_svd3_soa(f, sweeps=sweeps)
    proj = matmul33_nt(U, V)
    return tuple(0.5 * (p + z) for p, z in zip(proj, f))


def polar_rotation_3x2_tuple(f):
    """Closest orthonormal-column 3x2 to F on a 6-tuple, from the 2x2
    eigen-decomposition of F^T F with its fallbacks."""
    f00, f01, f10, f11, f20, f21 = f
    dtype = f00.dtype
    eps = torch.tensor(1e-12 if dtype == torch.float64 else 1e-7, dtype=dtype,
                       device=f00.device)

    # G = F^T F (2x2 SPD)
    a = f00 * f00 + f10 * f10 + f20 * f20
    b = f00 * f01 + f10 * f11 + f20 * f21
    c = f01 * f01 + f11 * f11 + f21 * f21

    tr = a + c
    disc = torch.sqrt(torch.clamp((a - c) * (a - c) + 4.0 * b * b, min=0.0))
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)

    v1x, v1y = b, l1 - a
    ax_, ay_ = l1 - c, b
    use_alt = v1x * v1x + v1y * v1y < ax_ * ax_ + ay_ * ay_
    v1x = torch.where(use_alt, ax_, v1x)
    v1y = torch.where(use_alt, ay_, v1y)
    n1 = torch.sqrt(v1x * v1x + v1y * v1y)
    ok = n1 > eps
    inv = 1.0 / torch.maximum(n1, eps)
    v1x = torch.where(ok, v1x * inv, 1.0)
    v1y = torch.where(ok, v1y * inv, 0.0)
    v2x, v2y = -v1y, v1x
    s1 = torch.sqrt(torch.clamp(l1, min=0.0))
    s2 = torch.sqrt(torch.clamp(l2, min=0.0))

    # U columns = F V / s with orthonormalization fallbacks.
    u1 = (f00 * v1x + f01 * v1y, f10 * v1x + f11 * v1y, f20 * v1x + f21 * v1y)
    u2 = (f00 * v2x + f01 * v2y, f10 * v2x + f11 * v2y, f20 * v2x + f21 * v2y)
    inv1 = 1.0 / torch.maximum(s1, eps)
    inv2 = 1.0 / torch.maximum(s2, eps)
    u1 = tuple(x * inv1 for x in u1)
    u2 = tuple(x * inv2 for x in u2)

    nu1 = torch.sqrt(dot3(u1, u1))
    ok1 = nu1 > eps
    iu1 = 1.0 / torch.maximum(nu1, eps)
    ex = (torch.ones_like(nu1), torch.zeros_like(nu1), torch.zeros_like(nu1))
    u1 = tuple(torch.where(ok1, x * iu1, e) for x, e in zip(u1, ex))

    proj = dot3(u2, u1)
    u2 = tuple(x - proj * y for x, y in zip(u2, u1))
    nu2 = torch.sqrt(dot3(u2, u2))
    ok2 = nu2 > eps
    iu2 = 1.0 / torch.maximum(nu2, eps)
    big0 = torch.abs(u1[0]) > 0.9
    ref = (torch.where(big0, 0.0, 1.0).to(dtype), torch.where(big0, 1.0, 0.0).to(dtype),
           torch.zeros_like(nu2))
    alt = cross3(u1, ref)
    altn = torch.sqrt(torch.maximum(dot3(alt, alt), eps * eps))
    alt = tuple(x / altn for x in alt)
    u2 = tuple(torch.where(ok2, x * iu2, y) for x, y in zip(u2, alt))

    # P = U V^T (3x2): P_rc = u1_r * v1_c + u2_r * v2_c.
    return (
        u1[0] * v1x + u2[0] * v2x, u1[0] * v1y + u2[0] * v2y,
        u1[1] * v1x + u2[1] * v2x, u1[1] * v1y + u2[1] * v2y,
        u1[2] * v1x + u2[2] * v2x, u1[2] * v1y + u2[2] * v2y,
    )


def prox_tri_tuple(f, limit_min, limit_max):
    """Cloth prox 1/2 (P + F) with hard strain limiting of the column norms
    on a 6-tuple (src/TriEnergyTerm.cpp:73-101)."""
    p = polar_rotation_3x2_tuple(f)
    z = tuple(0.5 * (pi + fi) for pi, fi in zip(p, f))
    z00, z01, z10, z11, z20, z21 = z

    check = (limit_min > 0.0) | (limit_max < 99.0)
    n0 = torch.sqrt(z00 * z00 + z10 * z10 + z20 * z20)
    n1 = torch.sqrt(z01 * z01 + z11 * z11 + z21 * z21)

    def clamp(n):
        safe = torch.clamp(n, min=1e-30)
        s = torch.ones_like(n)
        s = torch.where(n < limit_min, limit_min / safe, s)
        s = torch.where(n > limit_max, limit_max / safe, s)
        return torch.where(check, s, torch.ones_like(s))

    s0 = clamp(n0)
    s1 = clamp(n1)
    return (z00 * s0, z01 * s1, z10 * s0, z11 * s1, z20 * s0, z21 * s1)


def local_step_tri_plain(dix, u, limit_min, limit_max):
    """Fused cloth local step on rows [6, T] (plain version of kernel E):
    v = D x + u, z = prox(v), u' = v - z. Returns (z, u')."""
    v = dix + u
    z = torch.stack(prox_tri_tuple(tuple(v[i] for i in range(6)), limit_min, limit_max),
                    dim=0)
    return z, v - z
