"""Structure-of-arrays 3x3 algebra and the signed SVD, in PyTorch.

A port of ``admm_elastic_tpu/ops/soa.py:23-283``. Matrices are 9-tuples
of same-shape tensors in row-major entry order, vectors 3-tuples. Every
function performs the same operations in the same order as its JAX
counterpart: these are the plain versions of the body of kernel A
(``csrc/local_step.cu``), which repeats them line for line.

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
