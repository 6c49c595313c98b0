"""Negacyclic NTT tier — the algorithmic fast path for polynomial products.

Reference semantics: exact products in Z_{2^32}[X]/(X^N+1) (src/utils.rs:155-160).
The reference has no NTT at all (O(N^2) Toeplitz only, credited to jaxite at
src/utils.rs:12,182); this module is new design.

Why not a classic butterfly NTT: a radix-2 butterfly chain is elementwise
work with no matrix-unit use (analyzed in NOTES_NTT.md) and loses to the
int8 Toeplitz product at N=512.  Instead we use a **hybrid block-NTT** built
from integer matmuls:

  Z[X]/(X^N + 1)  with  N = N1 * N2,  Z := X^{N2}
    = polynomials sum_{j<N2} X^j * A_j(Z)   with   A_j in Z[Z]/(Z^{N1}+1)

  * the INNER ring Z[Z]/(Z^{N1}+1) goes through a single-matmul negacyclic
    NTT of size N1 (psi-twist folded into the [N1, N1] matrix) modulo two
    CRT primes p1=12289, p2=40961 (both = 1 mod 2*N1 for N1 | 2048);
  * the OUTER length-N2 convolution (with a Z-twist on wraparound, i.e. a
    *twisted circulant* in NTT domain) is merged with TFHE's row contraction
    sum_r digits_r (*) key_{r,c} into ONE int8 matmul per NTT bin:

        C_hat[bin, b, (c,lam,j_out)] =
            sum_{(r,j1)} D_hat[bin, b, (r,j1)] * K_hat[bin, (r,j1), (c,lam,j_out)]

    with contraction dim R*N2 (144 at default_128) — GEMM shapes, unlike
    the classic pointwise stage whose per-bin [1,R]x[R,C] products are
    too small for a matrix unit.

Exactness: all arithmetic is integer.  Residues mod p (|p| < 2^16) ride in
two balanced int8 limbs (base 256), so every matmul is int8 x int8 -> int32
with bounded accumulation; per-limb-plane accumulators are reduced mod p
BEFORE shift-combining, keeping every intermediate < 2^24.  The key side is
split into balanced base-2^kb limbs (kb chosen per plan so the true integer
convolution magnitude stays below P/2 = p1*p2/2), each limb an independent
integer convolution recovered exactly by a centered CRT lift and recombined
with wrapping u32 shifts.  Bit-exact vs ops/poly.py's Toeplitz backends
(tested).

Cost at default_128 (R=18, C=3, N=512, N1=64, N2=8), per sample per step:
~10M int8 MACs vs 56.6M for the Toeplitz path (5.7x) — see NOTES_NTT.md
for the full model.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
from jax import lax

#: CRT primes: p = 1 (mod 2*N1) for every power-of-two N1 <= 2048,
#: p < 2^16 so centered residues fit 2 balanced int8 limbs.
PRIMES = (12289, 40961)
#: product of PRIMES; exact lifts need |true integer coeff| < P_CRT / 2
P_CRT = PRIMES[0] * PRIMES[1]


# ---------------------------------------------------------------------------
# plan: static configuration (hashable; numpy tables derived and cached)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NttPlan:
    """Static shape/limb plan for one (N, rows, max_digit) workload.

    ``rows`` is the contraction row count R (digit polynomials), ``max_digit``
    the digit magnitude bound (16 for the base-16 gadget: digits lie in
    [-8,7] union {+16}, the reference's carry anomaly, src/decomposer.rs:42-80).
    ``key_bits``/``key_limbs`` define the balanced key split; chosen so that
    R * N * max_digit * 2^(key_bits-1) < P_CRT/2.
    """

    n: int  # polynomial degree N
    n1: int  # inner (NTT) size
    key_bits: int
    key_limbs: int
    max_digit: int

    @property
    def n2(self) -> int:
        return self.n // self.n1

    def __post_init__(self):
        assert self.n % self.n1 == 0
        assert self.n1 & (self.n1 - 1) == 0 and self.n1 <= 2048
        assert self.key_bits * self.key_limbs >= 32


def plan_for_params(params) -> NttPlan:
    """The PBS external-product plan for a parameter set: R = (k+1)*levels
    digit rows with |digit| <= B = 2^log_base (the +B carry anomaly included,
    src/decomposer.rs:42-80)."""
    dp = params.pbs_decomposer
    rows = (params.glwe_dimension + 1) * dp.levels
    return make_plan(params.degree, rows=rows, max_digit=1 << dp.log_base)


def make_plan(n: int, rows: int, max_digit: int = 16, n1: int | None = None) -> NttPlan:
    """Pick inner size and key-limb split for an R-row contraction at degree N.

    N1 defaults to the MAC-count sweet spot (inner cost ~ N1, outer ~ N2^2 per
    output) subject to the int32 accumulation bound R*N2 * 128^2 <= 2^30 on
    the merged outer matmul.
    """
    if n1 is None:
        n1 = 64
        while n1 < n and (n // n1) * rows * (1 << 14) > (1 << 30):
            n1 *= 2
        n1 = min(n1, n, 2048)
    # balanced key limbs: R*N*max_digit*2^(kb-1) < P/2, top limb included
    kb = 1
    while rows * n * max_digit * (1 << kb) < P_CRT // 2 and kb < 16:
        kb += 1
    assert kb >= 2, "contraction too large for the 2-prime CRT range"
    limbs = -(-32 // kb)
    return NttPlan(n=n, n1=n1, key_bits=kb, key_limbs=limbs, max_digit=max_digit)


def _pow_mod(b: int, e: int, p: int) -> int:
    return pow(int(b), int(e), int(p))


def _find_psi(p: int, order: int) -> int:
    """Smallest primitive ``order``-th root of unity mod p (order | p-1)."""
    assert (p - 1) % order == 0
    for g in range(2, p):
        c = _pow_mod(g, (p - 1) // order, p)
        if _pow_mod(c, order // 2, p) != 1:
            return c
    raise ValueError("no root found")


@functools.lru_cache(maxsize=None)
def _tables(n1: int):
    """Per-prime numpy tables for the size-N1 negacyclic NTT.

    Returns dict with, per prime index:
      w_fwd  int32[N1, N1]: W[i, bin] = psi^{i(2bin+1)} mod p (centered)
      w_inv  int32[N1, N1]: W[bin, i] = psi^{-i(2bin+1)} / N1 mod p (centered)
      zhat   int32[N1]:     NTT eigenvalues of Z (= psi^{2bin+1}) mod p
    """
    out = []
    for p in PRIMES:
        psi = _find_psi(p, 2 * n1)
        i = np.arange(n1, dtype=np.int64)[:, None]
        b = np.arange(n1, dtype=np.int64)[None, :]
        psi_pow = np.array([_pow_mod(psi, e, p) for e in range(2 * n1)], np.int64)
        w_fwd = psi_pow[(i * (2 * b + 1)) % (2 * n1)]
        psi_inv = _pow_mod(psi, 2 * n1 - 1, p)
        psi_inv_pow = np.array(
            [_pow_mod(psi_inv, e, p) for e in range(2 * n1)], np.int64
        )
        n1_inv = _pow_mod(n1, p - 2, p)
        # W_inv[bin, i] = psi^{-i(2bin+1)} / N1  (bin = row, i = col)
        w_inv = (psi_inv_pow[(b * (2 * i + 1)) % (2 * n1)] * n1_inv) % p
        zhat = psi_pow[(2 * np.arange(n1, dtype=np.int64) + 1) % (2 * n1)]
        out.append(
            dict(
                w_fwd=_center_np(w_fwd, p).astype(np.int32),
                w_inv=_center_np(w_inv, p).astype(np.int32),
                zhat=zhat.astype(np.int32),  # kept in [0, p)
            )
        )
    return out


def _center_np(x, p):
    x = x % p
    return np.where(x > p // 2, x - p, x)


# ---------------------------------------------------------------------------
# modular / limb helpers (jnp)
# ---------------------------------------------------------------------------


def mod_center(x, p: int) -> jnp.ndarray:
    """int32[...] -> centered residue in [-(p//2), p//2] (exact)."""
    r = jnp.remainder(x, jnp.int32(p))  # floor-mod: [0, p)
    return r - jnp.int32(p) * (r > jnp.int32(p // 2)).astype(jnp.int32)


def split2_i8(x) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Centered int32 (|x| <= 2^14.4) -> (hi, lo) int8 with x = hi*256 + lo,
    lo in [-128, 128)."""
    lo = ((x + 128) & 255) - 128
    hi = (x - lo) >> 8
    return hi.astype(jnp.int8), lo.astype(jnp.int8)


def key_limbs_i32(g_u32, key_bits: int, key_limbs: int) -> jnp.ndarray:
    """u32[...] -> int32[key_limbs, ...] balanced base-2^key_bits limbs of the
    signed value: sum(limb_l << (key_bits*l)) == g (mod 2^32), |limb| <= 2^(kb-1)."""
    v = jnp.asarray(g_u32, jnp.uint32).astype(jnp.int32)  # mod-2^32 signed view
    half = 1 << (key_bits - 1)
    mask = (1 << key_bits) - 1
    limbs = []
    for _ in range(key_limbs - 1):
        lo = ((v + half) & mask) - half
        limbs.append(lo)
        v = (v - lo) >> key_bits
    limbs.append(v)
    return jnp.stack(limbs, axis=0)


def _matmul_i8_planes(lhs_hi, lhs_lo, rhs_hi, rhs_lo, dims):
    """Raw limb-plane products of (a_hi*256+a_lo) @ (b_hi*256+b_lo): returns
    (hh, hl+lh, ll) int32 accumulators WITHOUT modular combination.  The
    planes are linear in the contraction, so partial-contraction planes may
    be summed (e.g. psum over a sharded bin axis) before ``_combine_planes``."""

    def mm(a, b):
        return lax.dot_general(a, b, dims, preferred_element_type=jnp.int32)

    return mm(lhs_hi, rhs_hi), mm(lhs_hi, rhs_lo) + mm(lhs_lo, rhs_hi), mm(
        lhs_lo, rhs_lo
    )


def _combine_planes(hh, m, ll, p: int) -> jnp.ndarray:
    """(hh*256 + m)*256 + ll mod p, centered; reduces each plane mod p BEFORE
    shift-combining so every intermediate stays < 2^24."""
    x = mod_center((mod_center(hh, p) << 8) + mod_center(m, p), p)
    return mod_center((x << 8) + mod_center(ll, p), p)


def _matmul_i8_mod(lhs_hi, lhs_lo, rhs_hi, rhs_lo, p: int, dims) -> jnp.ndarray:
    """Exact (a_hi*256+a_lo) @ (b_hi*256+b_lo) mod p via 4 int8 matmuls."""
    hh, m, ll = _matmul_i8_planes(lhs_hi, lhs_lo, rhs_hi, rhs_lo, dims)
    return _combine_planes(hh, m, ll, p)


# ---------------------------------------------------------------------------
# key preparation (keygen-time)
# ---------------------------------------------------------------------------


def make_ep_ntt_key(bk_u32, plan: NttPlan) -> jnp.ndarray:
    """GGSW key u32[..., R, C, N] -> merged outer-matmul operand
    int8[..., n_primes, 2(hi/lo), N1(bin), R*N2, C*key_limbs*N2].

    Encodes, per NTT bin, the twisted-circulant block matrix
      K[(r,j1), (c,lam,j_out)] = NTT(G_lam[r,c, (j_out-j1) mod N2])[bin]
                                 * (zhat[bin] if j_out < j1 else 1)
    where G_j2(Z) gathers every N2-th coefficient of g (g[j2 + N2*i]) and
    lam indexes the balanced key limbs.  Built once at keygen; the rotation
    scan streams one step's slice per CMUX.
    """
    n1, n2, n = plan.n1, plan.n2, plan.n
    bk = jnp.asarray(bk_u32, jnp.uint32)
    *lead, r_dim, c_dim, n_ = bk.shape
    assert n_ == n
    tabs = _tables(n1)
    glimbs = key_limbs_i32(bk, plan.key_bits, plan.key_limbs)  # [L, ..., R, C, N]
    # [L, ..., R, C, N] -> [..., R, C, L, N2(j2), N1(i)]
    g = jnp.moveaxis(glimbs, 0, -2)
    g = g.reshape(g.shape[:-1] + (n1, n2))  # split N: index = i*N2 + j2
    g = jnp.swapaxes(g, -1, -2)  # [..., R, C, L, N2(j2), N1(i)]

    per_prime = []
    for p, t in zip(PRIMES, tabs):
        w = jnp.asarray(t["w_fwd"], jnp.int32)  # [N1(i), N1(bin)]
        gr = mod_center(g, p)
        # ghat[..., R, C, L, j2, bin] = sum_i g[..., i] * w[i, bin] mod p
        # (|g|<=2^(kb-1)<=2^15, |w|<=p/2: products ~2^30, contraction N1<=2048
        #  would overflow int32 -> split w into 2 int8 limbs, g stays int32*?
        #  g also up to 2^15 -> split both.)
        g_hi, g_lo = split2_i8(gr)
        w_hi, w_lo = split2_i8(w)
        dims = (((g.ndim - 1,), (0,)), ((), ()))
        ghat = _matmul_i8_mod(g_hi, g_lo, w_hi, w_lo, p, dims)
        # twisted circulant over (j1 -> j_out), z-twist on wraps
        j1 = jnp.arange(n2)[:, None]
        jout = jnp.arange(n2)[None, :]
        j2 = (jout - j1) % n2
        sel = jnp.take(ghat, j2.reshape(-1), axis=-2)  # [..., R,C,L, N2*N2, bin]
        sel = sel.reshape(ghat.shape[:-2] + (n2, n2, n1))  # [..., j1, jout, bin]
        zhat = jnp.asarray(t["zhat"], jnp.int32)  # [bin], in [0, p)
        wrapped = mod_center(sel * zhat, p)  # products < p^2/2*... < 2^31? see below
        sel = jnp.where((jout < j1)[..., None], wrapped, sel)
        # NB |sel| <= p/2, zhat < p: |sel*zhat| <= p^2/2 = 2^30.9 for p=40961 —
        # fits int32 (< 2^31) with the centered lhs; asserted by tests.
        # layout -> [prime, 2, bin, R*N2(j1), C*L*N2(jout)]
        x = jnp.moveaxis(sel, -1, 0)  # [bin, ..., R, C, L, j1, jout]
        x = jnp.moveaxis(x, -2, -4)  # [bin, ..., R, j1, C, L, jout]
        x = x.reshape(x.shape[:1] + tuple(lead) + (r_dim * n2, c_dim * plan.key_limbs * n2))
        hi, lo = split2_i8(x)
        per_prime.append(jnp.stack([hi, lo], axis=0))  # [2, bin, *lead, RN2, CLN2]
    out = jnp.stack(per_prime, axis=0)  # [P, 2, bin, *lead, RN2, CLN2]
    # -> [*lead, P, 2, bin, RN2, CLN2]
    out = jnp.moveaxis(out, (0, 1, 2), (len(lead), len(lead) + 1, len(lead) + 2))
    return out


# ---------------------------------------------------------------------------
# the contraction (per blind-rotation step)
# ---------------------------------------------------------------------------


def ntt_fwd_digits(digits_i8, plan: NttPlan):
    """int8[B, R, N] digits -> list per prime of (hi, lo) int8[N1(bin), B, R*N2]."""
    b, r_dim, n = digits_i8.shape
    n1, n2 = plan.n1, plan.n2
    d = digits_i8.reshape(b, r_dim, n1, n2)  # coeff index = i*N2 + j1
    tabs = _tables(n1)
    outs = []
    for pi, t in enumerate(tabs):
        p = int(PRIMES[pi])
        w = jnp.asarray(t["w_fwd"], jnp.int32)
        w_hi, w_lo = split2_i8(w)
        # contract i: out[bin, b, r, j1] = sum_i w[i, bin] * d[b, r, i, j1]
        # products |d| <= max_digit (or 128 for general limbs) x |w_limb| <= 128,
        # contraction N1 <= 2048 -> int32-safe with 2 key-limb matmuls
        dims = (((0,), (2,)), ((), ()))  # lhs w[i, bin] over i; rhs d over axis 2

        def mm(wl):
            return lax.dot_general(
                wl, d, dims, preferred_element_type=jnp.int32
            )  # [bin, B, R, N2]

        hi = mod_center(mm(w_hi), p)
        lo = mod_center(mm(w_lo), p)
        dh = mod_center((hi << 8) + lo, p)  # [bin, B, R, N2]
        dh = dh.reshape(n1, b, r_dim * n2)
        outs.append(split2_i8(dh))
    return outs


def ep_contract_ntt(digits_i8, bk_ntt_step, plan: NttPlan, c_dim: int) -> jnp.ndarray:
    """Full NTT-domain external product contraction.

    digits int8[B, R, N]; bk_ntt_step int8[P, 2, N1, R*N2, C*L*N2]
    (one step's slice of ``make_ep_ntt_key``) -> u32[B, C, N] wrapping delta.
    """
    b = digits_i8.shape[0]
    n1, n2, L = plan.n1, plan.n2, plan.key_limbs
    dhats = ntt_fwd_digits(digits_i8, plan)
    tabs = _tables(n1)
    res = []
    for pi, t in enumerate(tabs):
        p = int(PRIMES[pi])
        d_hi, d_lo = dhats[pi]  # [bin, B, RN2]
        k_hi = bk_ntt_step[pi, 0]  # [bin, RN2, CLN2]
        k_lo = bk_ntt_step[pi, 1]
        # batched over bin: [bin, B, RN2] @ [bin, RN2, CLN2]
        dims = (((2,), (1,)), ((0,), (0,)))
        chat = _matmul_i8_mod(d_hi, d_lo, k_hi, k_lo, p, dims)  # [bin, B, CLN2]
        # INTT: contract bin -> [B, CLN2, N1(i)]
        w_inv = jnp.asarray(t["w_inv"], jnp.int32)  # [bin, i]
        c_hi, c_lo = split2_i8(chat)
        wi_hi, wi_lo = split2_i8(w_inv)
        dims2 = (((0,), (0,)), ((), ()))
        cints = _matmul_i8_mod(
            c_hi, c_lo, wi_hi, wi_lo, p, dims2
        )  # contracting bin: lhs [bin, B, CLN2] rhs [bin, i] -> [B, CLN2, i]
        res.append(cints)
    return _crt_lift_combine(res, plan, c_dim, b)


def _crt_lift_combine(res, plan: NttPlan, c_dim: int, b: int) -> jnp.ndarray:
    """Per-prime centered INTT residues [B, C*L*N2, N1] -> u32[B, C, N]:
    centered CRT lift, limb recombination, coefficient reorder."""
    n1, n2, L = plan.n1, plan.n2, plan.key_limbs
    # centered CRT lift: S = r1 + p1 * center((r2 - r1) * inv(p1) mod p2)
    p1, p2 = PRIMES
    inv_p1 = _pow_mod(p1, p2 - 2, p2)
    t2 = mod_center((res[1] - res[0]) * jnp.int32(inv_p1), p2)
    s = res[0] + jnp.int32(p1) * t2  # |S| < P/2 < 2^31: exact int32
    # [B, C, L, N2(jout), N1(i)] -> combine limbs, reorder N = i*N2 + jout
    s = s.reshape(b, c_dim, L, n2, n1)
    s = jnp.swapaxes(s, -1, -2)  # [B, C, L, N1(i), N2(jout)]
    s = s.reshape(b, c_dim, L, plan.n)
    su = s.astype(jnp.uint32)
    out = su[:, :, 0]
    for l in range(1, L):
        out = out + (su[:, :, l] << jnp.uint32(plan.key_bits * l))
    return out


# ---------------------------------------------------------------------------
# bin-sharded contraction (the NTT-stage-parallel / SP analog,
# SURVEY.md section 2.2 row 3): each shard owns a contiguous slice of the N1
# NTT bins — forward NTT, merged matmul and the partial INTT are all local;
# only raw int32 INTT limb planes cross the mesh (psum), after which the
# modular combine + CRT lift run replicated.  Bit-exact vs single-device.
# ---------------------------------------------------------------------------


def ntt_fwd_digits_cols(digits_i8, plan: NttPlan, bin_start, bins_local: int):
    """``ntt_fwd_digits`` restricted to bins [bin_start, bin_start+bins_local);
    ``bin_start`` may be traced (the shard offset)."""
    b, r_dim, n = digits_i8.shape
    n1, n2 = plan.n1, plan.n2
    d = digits_i8.reshape(b, r_dim, n1, n2)
    outs = []
    for p, t in zip(PRIMES, _tables(n1)):
        w = lax.dynamic_slice_in_dim(
            jnp.asarray(t["w_fwd"], jnp.int32), bin_start, bins_local, axis=1
        )
        w_hi, w_lo = split2_i8(w)
        dims = (((0,), (2,)), ((), ()))

        def mm(wl):
            return lax.dot_general(wl, d, dims, preferred_element_type=jnp.int32)

        dh = mod_center((mod_center(mm(w_hi), p) << 8) + mod_center(mm(w_lo), p), p)
        outs.append(split2_i8(dh.reshape(bins_local, b, r_dim * n2)))
    return outs


def ep_contract_ntt_partial(
    digits_i8, bk_ntt_local, plan: NttPlan, c_dim: int, bin_start, bins_local: int
) -> jnp.ndarray:
    """Local-bin partial contraction: int32[P, 3, B, C*L*N2, N1] raw INTT limb
    planes (hh, hl+lh, ll per prime), linear in the bin axis — psum them
    across shards, then ``ep_finish_ntt``.  ``bk_ntt_local`` is the local bin
    slice of ``make_ep_ntt_key``'s output: int8[P, 2, bins_local, RN2, CLN2]."""
    dhats = ntt_fwd_digits_cols(digits_i8, plan, bin_start, bins_local)
    per_prime = []
    for pi, (p, t) in enumerate(zip(PRIMES, _tables(plan.n1))):
        d_hi, d_lo = dhats[pi]  # [bins_local, B, RN2]
        k_hi = bk_ntt_local[pi, 0]
        k_lo = bk_ntt_local[pi, 1]
        dims = (((2,), (1,)), ((0,), (0,)))
        chat = _matmul_i8_mod(d_hi, d_lo, k_hi, k_lo, p, dims)  # [bins, B, CLN2]
        w_inv = lax.dynamic_slice_in_dim(
            jnp.asarray(t["w_inv"], jnp.int32), bin_start, bins_local, axis=0
        )
        c_hi, c_lo = split2_i8(chat)
        wi_hi, wi_lo = split2_i8(w_inv)
        dims2 = (((0,), (0,)), ((), ()))
        planes = _matmul_i8_planes(c_hi, c_lo, wi_hi, wi_lo, dims2)
        per_prime.append(jnp.stack(planes, axis=0))  # [3, B, CLN2, N1]
    return jnp.stack(per_prime, axis=0)  # [P, 3, B, CLN2, N1]


def ep_finish_ntt(planes, plan: NttPlan, c_dim: int) -> jnp.ndarray:
    """Combine (psum'd) raw INTT limb planes -> u32[B, C, N] wrapping delta.

    Plane magnitudes stay int32-safe across the full bin range: each raw plane
    entry is a sum of <= N1 (<=2048) int8*int8 products (< 2^25), and psum
    only ever restores the full-bin total."""
    b = planes.shape[2]
    res = [
        _combine_planes(planes[pi, 0], planes[pi, 1], planes[pi, 2], p)
        for pi, p in enumerate(PRIMES)
    ]
    return _crt_lift_combine(res, plan, c_dim, b)


# ---------------------------------------------------------------------------
# general negacyclic product (API parity with src/utils.rs:155-160)
# ---------------------------------------------------------------------------


def poly_mul_ntt(a_u32, b_u32) -> jnp.ndarray:
    """Exact u32 negacyclic product via the block-NTT (general operands).

    Reuses the EP machinery: a's 4 balanced base-256 limbs act as the
    small "digit" rows (|limb| <= 128) against a key of shifted copies of b
    (g_r = b << 8r mod 2^32) — sum_r conv(a_r, b<<8r) == conv(a, b) mod 2^32.
    """
    a = jnp.asarray(a_u32, jnp.uint32)
    bq = jnp.asarray(b_u32, jnp.uint32)
    assert a.shape == bq.shape
    lead = a.shape[:-1]
    n = a.shape[-1]
    a2 = a.reshape(-1, n)
    b2 = bq.reshape(-1, n)
    plan = make_plan(n, rows=4, max_digit=128)
    from tfhe_jax.ops.torus import to_signed_limbs

    digits = jnp.moveaxis(to_signed_limbs(a2), -1, 1)  # int8[B, 4, N]
    shifts = (jnp.uint32(8) * jnp.arange(4, dtype=jnp.uint32))[:, None]
    key = (b2[:, None, :] << shifts)[..., None, :]  # u32[B, 4(R), 1(C), N]
    bk_ntt = make_ep_ntt_key(key, plan)  # [B, P, 2, bin, 4*N2, L*N2]
    import jax

    out = jax.vmap(
        lambda d, k: ep_contract_ntt(d[None], k, plan, c_dim=1)[0, 0]
    )(digits, bk_ntt)
    return out.reshape(lead + (n,))
