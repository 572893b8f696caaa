"""
3+1 (three active + one sterile) neutrino oscillations through layered
matter, in XLA.

Native replacement for the sterile-neutrino capability the reference gets
from the external nuSQuIDS engine (``pisa/stages/osc/nusquids.py:36-140``:
4-flavor propagation, NC matter potential for the sterile state, low-pass
filtering of fast oscillations). Design:

- **split-complex 4x4 algebra** on stacked ``(4, 4, N)`` arrays (same
  split-complex and SoA layout rationale as
  ``ops/osc/kernels.py``), with einsum-based matmuls — at 4x4 the fully
  unrolled form no longer pays, and einsum keeps the HLO compact.
- **eigenvalues via the real-symmetric embedding**: a Hermitian H = A + iB
  embeds as the real-symmetric ``[[A, -B], [B, A]]`` whose spectrum is that
  of H duplicated; ``jnp.linalg.eigvalsh`` on the 8x8 embedding is
  real-valued and batched. (The 3-flavor kernel uses the analytic cubic;
  the quartic closed form is numerically treacherous, and the sterile path
  is not the hot loop.)
- **Barger spectral-projector transition matrices** exactly as in the
  3-flavor kernel (permutation-symmetric in the eigenvalues, so the
  embedding's eigenvalue ordering is irrelevant):
  ``T = sum_k exp(-i m_k L hc / E) prod_{j!=k} (2E H - m_j)/(m_k - m_j)``.
- **matter potentials**: with the common neutral-current potential removed
  as a global phase, ``H_mat = diag(a_e, 0, 0, a_n/2)`` where
  ``a_e = 0.5 rho_e 2sqrt2 G_F`` (electron-weighted column density, as in
  3-flavor) and ``a_n = 0.5 rho_n 2sqrt2 G_F`` (neutron-weighted;
  ``V_NC = -G_F n_n / sqrt2`` acts on actives only, so the sterile entry is
  ``-V_NC`` after the shift). Antineutrinos: ``H_mat -> -conj``.
- **low-pass fast-oscillation filtering** (nuSQuIDS
  ``Set_EvolLowPassCutoff/Scale`` semantics): optional density-matrix
  propagation where each layer's interference terms between eigenstate
  pairs (k, j) are damped by a cosine ramp on the pair's spatial frequency
  ``|m_k - m_j| hc / E`` [1/km]; expressed purely with the spectral
  projectors, ``rho' = sum_{kj} c_k conj(c_j) f_kj P_k rho P_j``, so no
  eigenvectors are ever materialized.

The 4-flavor mixing matrix follows the nuSQuIDS rotation order
``U = R34(th34) R24(th24, dcp24) R14(th14, dcp14) R23(th23) R13(th13, dcp13)
R12(th12)`` so parameter values are interchangeable with the reference's
nusquids service (``nusquids.py:394-428``).

All functions are differentiable w.r.t. the oscillation parameters
(mass splittings and the mixing matrix entries are traced).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from pisa_tpu.ops.cplx import C
from pisa_tpu.ops.osc.kernels import HBAR_C_FACTOR, TWO_SQRT2_GF

__all__ = [
    "pmns4_matrix",
    "osc_probs_layers_4nu",
]


# ---------------------------------------------------------------------------
# batched split-complex 4x4 helpers on (4, 4, ...) stacks
# ---------------------------------------------------------------------------
def _mul(a: C, b: C) -> C:
    """Matrix product over the two leading axes: (n,n,...) @ (n,n,...)."""
    rr = jnp.einsum("ik...,kj...->ij...", a.re, b.re)
    ii = jnp.einsum("ik...,kj...->ij...", a.im, b.im)
    ri = jnp.einsum("ik...,kj...->ij...", a.re, b.im)
    ir = jnp.einsum("ik...,kj...->ij...", a.im, b.re)
    return C(rr - ii, ri + ir)


def _conj_T(a: C) -> C:
    return C(jnp.swapaxes(a.re, 0, 1), -jnp.swapaxes(a.im, 0, 1))


def _rot(n, i, j, theta, delta=None):
    """Complex Givens rotation R_ij(theta, delta) as C (n, n): the nuSQuIDS
    building block — c at [i,i],[j,j]; s e^{-i delta} at [i,j];
    -s e^{+i delta} at [j,i]."""
    theta = jnp.asarray(theta)
    dtype = theta.dtype
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    re = jnp.eye(n, dtype=dtype)
    im = jnp.zeros((n, n), dtype=dtype)
    re = re.at[i, i].set(c).at[j, j].set(c)
    if delta is None:
        re = re.at[i, j].set(s).at[j, i].set(-s)
    else:
        cd = jnp.cos(jnp.asarray(delta))
        sd = jnp.sin(jnp.asarray(delta))
        re = re.at[i, j].set(s * cd).at[j, i].set(-s * cd)
        im = im.at[i, j].set(-s * sd).at[j, i].set(-s * sd)
    return C(re, im)


def pmns4_matrix(
    theta12, theta13, theta23, theta14, theta24, theta34,
    deltacp13=0.0, deltacp14=0.0, deltacp24=0.0,
):
    """3+1 mixing matrix in the nuSQuIDS rotation order (angles in rad,
    all traceable/differentiable). Returns C (4, 4).

    ``U = R34 R24(dcp24) R14(dcp14) R23 R13(dcp13) R12`` — for
    ``theta14 = theta24 = theta34 = 0`` the active 3x3 block is exactly the
    standard PDG PMNS matrix.
    """
    r12 = _rot(4, 0, 1, theta12)
    r13 = _rot(4, 0, 2, theta13, deltacp13)
    r23 = _rot(4, 1, 2, theta23)
    r14 = _rot(4, 0, 3, theta14, deltacp14)
    r24 = _rot(4, 1, 3, theta24, deltacp24)
    r34 = _rot(4, 2, 3, theta34)
    return _mul(_mul(_mul(r34, r24), r14), _mul(r23, _mul(r13, r12)))


# ---------------------------------------------------------------------------
# eigenvalues of a batched Hermitian C (4, 4, N)
# ---------------------------------------------------------------------------
def _eigvals_hermitian4(H: C):
    """Eigenvalues (N, 4) of Hermitian H (4, 4, N) via the real-symmetric
    8x8 embedding [[A, -B], [B, A]] (spectrum duplicated)."""
    A = jnp.moveaxis(H.re, -1, 0)  # (N, 4, 4)
    B = jnp.moveaxis(H.im, -1, 0)
    top = jnp.concatenate([A, -B], axis=-1)
    bot = jnp.concatenate([B, A], axis=-1)
    M = jnp.concatenate([top, bot], axis=-2)  # (N, 8, 8)
    # enforce exact symmetry against fp round-off
    M = 0.5 * (M + jnp.swapaxes(M, -1, -2))
    w = jnp.linalg.eigvalsh(M)  # (N, 8) ascending, duplicated pairs
    return w[..., ::2]  # (N, 4)


# ---------------------------------------------------------------------------
# per-layer transition (Barger spectral projectors, 4 flavors)
# ---------------------------------------------------------------------------
def _layer_phase_and_projectors(
    U, dm_vac4, nubar, energy, rho_e, rho_n, baseline,
):
    """Shared per-layer algebra: mass-basis 2E-scaled Hamiltonian spectral
    projectors P_k (list of 4 C (4,4,M)), eigenvalues m (M, 4), and phases
    c_k = exp(-i m_k s) (list of 4 C (M,)).

    energy/rho_e/rho_n/baseline: (M,) flattened (layer, point) batch.
    """
    dtype = energy.dtype
    # vacuum Hamiltonian in flavor basis (no 1/2E): U diag(dm) U^dagger
    d = jnp.stack(
        [jnp.zeros_like(dm_vac4[1]), dm_vac4[1], dm_vac4[2], dm_vac4[3]]
    )
    Ud = C(U.re * d[None, :], U.im * d[None, :])
    H_vac = _mul(Ud, _conj_T(U))  # (4,4)

    one_over_2e = 0.5 / energy  # (M,)
    a_e = 0.5 * rho_e * TWO_SQRT2_GF
    a_s = 0.25 * rho_n * TWO_SQRT2_GF  # sterile entry: -V_NC = +a_n/2
    sign = 1.0 if nubar > 0 else -1.0

    diag = jnp.zeros((4, 4, energy.shape[0]), dtype=dtype)
    diag = diag.at[0, 0].set(sign * a_e).at[3, 3].set(sign * a_s)
    H_full = C(
        H_vac.re[..., None] * one_over_2e + diag,
        jnp.broadcast_to(H_vac.im[..., None] * one_over_2e, diag.shape),
    )

    m = _eigvals_hermitian4(H_full) * (2.0 * energy)[:, None]  # (M, 4)

    Ub = C(U.re[..., None], U.im[..., None])
    H_mass = _mul(_mul(_conj_T(Ub), H_full), Ub)
    H2e = C(
        H_mass.re * (2.0 * energy), H_mass.im * (2.0 * energy)
    )  # (4,4,M)

    eye = jnp.eye(4, dtype=dtype)[..., None]

    # --- deflated spectral projectors --------------------------------------
    # Conditioning: with an eV^2-scale dm41, ||H2e|| ~ dm41 while the
    # active-cluster gaps are ~dm21. In the naive Barger product the
    # (H2e - m_far) factor must annihilate the isolated (sterile-dominated)
    # eigendirection to the precision of m_far itself — an fp32 eigenvalue
    # error of eps*dm41 gets amplified by the inverse cluster gaps
    # (1/dm21 * 1/dm31), observed as O(100) "probabilities" at fp32.
    # Deflation fixes it: build the ISOLATED state's projector first (all
    # of its gaps are ~dm41, so it is well-conditioned), then compute the
    # three cluster projectors from the deflated matrix A = Q H2e Q
    # (spectral radius ~cluster scale) and re-apply Q to kill the residual
    # leakage. The isolated eigenvalue is the first or last of the sorted
    # spectrum (one sterile state); selected per point.
    far_is_3 = (m[:, 3] - m[:, 2]) >= (m[:, 1] - m[:, 0])  # (M,)
    m_far = jnp.where(far_is_3, m[:, 3], m[:, 0])
    mc = [
        jnp.where(far_is_3, m[:, 0], m[:, 1]),
        jnp.where(far_is_3, m[:, 1], m[:, 2]),
        jnp.where(far_is_3, m[:, 2], m[:, 3]),
    ]

    def _hfac(c, denom):
        # (H2e - c I) / denom, c/denom (M,)
        return C((H2e.re - eye * c) / denom, H2e.im / denom)

    P_far = _mul(
        _hfac(mc[0], m_far - mc[0]),
        _mul(_hfac(mc[1], m_far - mc[1]), _hfac(mc[2], m_far - mc[2])),
    )
    Q = C(eye - P_far.re, -P_far.im)
    A = _mul(Q, _mul(H2e, Q))

    def _afac(c, denom):
        return C((A.re - eye * c) / denom, A.im / denom)

    # --- second-level deflation --------------------------------------------
    # The active cluster itself contains a near-degenerate pair at high
    # energy (mu/tau feel identical matter potentials, so once the vacuum
    # splittings dm21/2E, dm31/2E are negligible two cluster eigenvalues
    # coincide to ~dm21 while the matter-split e-like state sits ~2E*V_CC
    # away).  Building all three cluster projectors directly from A divides
    # an eps*||A|| eigenvalue error by that tiny pair gap — observed as ~7%
    # unitarity violation at fp32 around the 500 GeV sterile resonance.
    # Recurse: split off the most ISOLATED cluster extreme (all of its gaps
    # are ~the cluster spread, well-conditioned), deflate again, and build
    # the remaining PAIR's projectors from A2 = Q2 A Q2 whose spectral
    # radius is ~the pair spread itself, so the division is ~eps-accurate.
    iso_is_2 = (mc[2] - mc[1]) >= (mc[1] - mc[0])  # (M,)
    m_iso = jnp.where(iso_is_2, mc[2], mc[0])
    m_p = jnp.where(iso_is_2, mc[0], mc[1])  # the remaining pair
    m_q = jnp.where(iso_is_2, mc[1], mc[2])

    P_iso = _mul(
        _afac(m_p, m_iso - m_p), _afac(m_q, m_iso - m_q)
    )
    P_iso = _mul(Q, _mul(P_iso, Q))

    Q2 = C(Q.re - P_iso.re, Q.im - P_iso.im)
    A2 = _mul(Q2, _mul(A, Q2))

    def _a2fac(c, denom):
        return C((A2.re - eye * c) / denom, A2.im / denom)

    P_p = _mul(Q2, _mul(_a2fac(m_q, m_p - m_q), Q2))
    P_q = C(Q2.re - P_p.re, Q2.im - P_p.im)

    # restore the sorted cluster order (projector list order is arbitrary —
    # each is paired with its own eigenvalue below — but keep it tidy)
    def _sel(cond, x, y):
        return C(jnp.where(cond, x.re, y.re), jnp.where(cond, x.im, y.im))

    cluster_projs = [
        _sel(iso_is_2, P_p, P_iso),
        _sel(iso_is_2, P_q, P_p),
        _sel(iso_is_2, P_iso, P_q),
    ]

    projectors = cluster_projs + [P_far]
    m_list = mc + [m_far]  # aligned with `projectors`

    s = -(baseline / energy) * HBAR_C_FACTOR  # (M,)
    phases = [
        C(jnp.cos(mk * s), jnp.sin(mk * s)) for mk in m_list
    ]
    m_aligned = jnp.stack(m_list, axis=-1)  # (M, 4), projector-aligned
    return projectors, m_aligned, phases, s


def _layer_transition_4nu(
    U, dm_vac4, nubar, energy, rho_e, rho_n, baseline,
):
    """One-layer mass-basis transition amplitudes T (4, 4, M)."""
    projectors, _, phases, _ = _layer_phase_and_projectors(
        U, dm_vac4, nubar, energy, rho_e, rho_n, baseline
    )
    T_re = 0.0
    T_im = 0.0
    for k in range(4):
        p, pk = phases[k], projectors[k]
        T_re = T_re + p.re * pk.re - p.im * pk.im
        T_im = T_im + p.re * pk.im + p.im * pk.re
    return C(T_re, T_im)


def _unitarize(T: C) -> C:
    """One Newton–Schulz polar-decomposition step:
    ``T <- 1.5 T - 0.5 T (T^dag T)``.

    The exact one-layer transition exp(-i H s) is unitary; fp32 spectral-
    projector construction error leaves ``T = W (I + S)`` with W unitary
    and S small Hermitian (the non-unitary error component). One NS step
    maps it to ``W (I + O(S^2))`` — i.e. projects onto the unitary manifold
    to second order, removing the part of the error that accumulates as
    unitarity violation along the layer chain, while the in-manifold
    (phase) error is already eps-bounded by the deflated projectors.
    Measured on the resonance stress set (tests/test_sterile.py): worst
    |row sum - 1| drops ~5.5e-3 -> <1e-5 at fp32; at fp64 it is a no-op at
    machine precision. Cost: two 4x4 matmuls per layer-point vs the 8x8
    eigendecomposition already paid.
    """
    TtT = _mul(_conj_T(T), T)
    corr = _mul(T, TtT)
    return C(1.5 * T.re - 0.5 * corr.re, 1.5 * T.im - 0.5 * corr.im)


@partial(
    jax.jit,
    static_argnames=("nubar", "lowpass_cutoff", "lowpass_frac"),
)
def osc_probs_layers_4nu(
    dm_vac4,
    mix4,
    nubar,
    energy,
    densities,
    densities_neutron,
    distances,
    lowpass_cutoff=0.0,
    lowpass_frac=0.1,
):
    """3+1 oscillation probabilities through a chain of matter layers.

    Parameters
    ----------
    dm_vac4 : (4,) real — (0, dm21, dm31, dm41) in eV^2
    mix4 : C (4, 4) — from :func:`pmns4_matrix`
    nubar : static int, +1 nu / -1 nubar
    energy : (N,) GeV
    densities : (N, L) electron column densities (mol/cm^3)
    densities_neutron : (N, L) neutron-weighted column densities
    distances : (N, L) layer path lengths (km); zero-length slots are
        identity
    lowpass_cutoff : static float, 1/km; 0 disables. When set, propagation
        switches to the density-matrix picture and interference between
        eigenstate pairs whose spatial frequency exceeds the cutoff is
        damped with a cosine ramp starting at ``(1-frac)*cutoff``
        (nuSQuIDS ``Set_EvolLowPassCutoff/Scale``,
        cf. reference ``nusquids.py:431-439``).

    Returns
    -------
    probs : (N, 4, 4); probs[n, a, b] = P(nu_a -> nu_b),
        flavor order (e, mu, tau, sterile).
    """
    U = mix4 if nubar > 0 else C(mix4.re, -mix4.im)
    dm_vac4 = jnp.asarray(dm_vac4)
    energy = jnp.asarray(energy)
    densities = jnp.asarray(densities)
    densities_neutron = jnp.asarray(densities_neutron)
    distances = jnp.asarray(distances)

    n_pts = energy.shape[0]
    n_layers = distances.shape[1]
    dtype = energy.dtype

    e_flat = jnp.broadcast_to(energy, (n_layers, n_pts)).reshape(-1)
    rho_e_flat = jnp.swapaxes(densities, 0, 1).reshape(-1)
    rho_n_flat = jnp.swapaxes(densities_neutron, 0, 1).reshape(-1)
    dist_flat = jnp.swapaxes(distances, 0, 1).reshape(-1)
    keep = dist_flat > 0.0

    eye = jnp.eye(4, dtype=dtype)[..., None]

    if not lowpass_cutoff:
        # amplitude picture: ordered product of one-layer transitions
        T = _layer_transition_4nu(
            U, dm_vac4, nubar, e_flat, rho_e_flat, rho_n_flat, dist_flat
        )
        T = C(
            jnp.where(keep, T.re, eye),
            jnp.where(keep, T.im, jnp.zeros((), dtype=dtype)),
        )
        T = _unitarize(T)  # identity slots are fixed points
        T_stack = C(
            T.re.reshape(4, 4, n_layers, n_pts).transpose(2, 0, 1, 3),
            T.im.reshape(4, 4, n_layers, n_pts).transpose(2, 0, 1, 3),
        )
        init = C(
            jnp.broadcast_to(jnp.eye(4, dtype=dtype)[..., None], (4, 4, n_pts)),
            jnp.zeros((4, 4, n_pts), dtype=dtype),
        )

        def chain_body(prod, T_l):
            return _mul(T_l, prod), None

        product, _ = jax.lax.scan(chain_body, init, T_stack)
        # to flavor basis: U T U^dagger; probs[n, a, b] = |T_f[b, a, n]|^2
        Ub = C(U.re[..., None], U.im[..., None])
        product = _mul(_mul(Ub, product), _conj_T(Ub))
        return jnp.transpose(
            product.re**2 + product.im**2, (2, 1, 0)
        )

    # ---- low-pass density-matrix picture ---------------------------------
    projectors, m, phases, _ = _layer_phase_and_projectors(
        U, dm_vac4, nubar, e_flat, rho_e_flat, rho_n_flat, dist_flat
    )
    # pair damping factors f_kj from the spatial frequency of (m_k - m_j)
    freq = jnp.abs(m[:, :, None] - m[:, None, :]) * (
        HBAR_C_FACTOR / e_flat[:, None, None]
    )  # (M, 4, 4) rad/km
    lo = (1.0 - lowpass_frac) * lowpass_cutoff
    ramp = jnp.clip((freq - lo) / max(lowpass_cutoff - lo, 1e-12), 0.0, 1.0)
    f = 0.5 * (1.0 + jnp.cos(jnp.pi * ramp))  # 1 below, 0 above

    # per-layer superoperator applied to a stack of 4 initial-flavor
    # density matrices rho_a: rho' = sum_{k,j} c_k conj(c_j) f_kj P_k rho P_j
    # (P_k built from the mass-basis H2e, so rho is propagated in the mass
    # basis and rotated to flavor at the ends). rho is stored (4, 4, B, N):
    # leading axes are the matrix dims so the einsum-based `_mul` broadcasts
    # the trailing (B, N) batch.
    def rho_step(rho, layer):
        P_re, P_im, c_re, c_im, f_l, keep_l = layer
        out_re = jnp.zeros_like(rho.re)
        out_im = jnp.zeros_like(rho.im)
        for k in range(4):
            Pk = C(P_re[k][..., None, :], P_im[k][..., None, :])  # (4,4,1,N)
            Xk = _mul(Pk, rho)
            for j in range(4):
                Pj = C(P_re[j][..., None, :], P_im[j][..., None, :])
                Y = _mul(Xk, _conj_T(Pj))
                # w = c_k * conj(c_j) * f_kj : (N,)
                wr = (c_re[k] * c_re[j] + c_im[k] * c_im[j]) * f_l[:, k, j]
                wi = (c_im[k] * c_re[j] - c_re[k] * c_im[j]) * f_l[:, k, j]
                out_re = out_re + wr * Y.re - wi * Y.im
                out_im = out_im + wr * Y.im + wi * Y.re
        out_re = jnp.where(keep_l, out_re, rho.re)
        out_im = jnp.where(keep_l, out_im, rho.im)
        return C(out_re, out_im), None

    # stack per-layer data for the scan
    P_re = jnp.stack([p.re for p in projectors])  # (4, 4, 4, L*N)
    P_im = jnp.stack([p.im for p in projectors])
    P_re = P_re.reshape(4, 4, 4, n_layers, n_pts).transpose(3, 0, 1, 2, 4)
    P_im = P_im.reshape(4, 4, 4, n_layers, n_pts).transpose(3, 0, 1, 2, 4)
    c_re = jnp.stack([p.re for p in phases]).reshape(
        4, n_layers, n_pts
    ).transpose(1, 0, 2)  # (L, 4, N)
    c_im = jnp.stack([p.im for p in phases]).reshape(
        4, n_layers, n_pts
    ).transpose(1, 0, 2)
    f_stack = f.reshape(n_layers, n_pts, 4, 4)  # (L, N, 4, 4)
    keep_stack = keep.reshape(n_layers, n_pts)  # (L, N)

    # initial rho_a in the MASS basis: rho_a = U^dag |a><a| U; column a of
    # U^dag is conj(row a of U)
    rho0_re = jnp.zeros((4, 4, 4, n_pts), dtype=dtype)  # (4, 4, B=a, N)
    rho0_im = jnp.zeros((4, 4, 4, n_pts), dtype=dtype)
    for a in range(4):
        uar = jnp.broadcast_to(U.re[a, :, None], (4, n_pts))
        uai = jnp.broadcast_to(-U.im[a, :, None], (4, n_pts))
        # rho0 = v v^dag with v = conj(U[a, :])
        rho0_re = rho0_re.at[:, :, a, :].set(
            uar[:, None, :] * uar[None, :, :]
            + uai[:, None, :] * uai[None, :, :]
        )
        rho0_im = rho0_im.at[:, :, a, :].set(
            uai[:, None, :] * uar[None, :, :]
            - uar[:, None, :] * uai[None, :, :]
        )
    rho = C(rho0_re, rho0_im)

    rho, _ = jax.lax.scan(
        rho_step, rho, (P_re, P_im, c_re, c_im, f_stack, keep_stack),
    )

    # back to flavor basis: P(a->b) = <b| U rho_a U^dag |b>
    #                              = u_b . (rho_a . conj(u_b)) , u_b = U[b,:]
    probs = []
    for b in range(4):
        ubr = U.re[b, :]  # (4,)
        ubi = U.im[b, :]
        # v = rho_a conj(u_b): (4, B, N)
        vr = jnp.einsum("ijBn,j->iBn", rho.re, ubr) + jnp.einsum(
            "ijBn,j->iBn", rho.im, ubi
        )
        vi = jnp.einsum("ijBn,j->iBn", rho.im, ubr) - jnp.einsum(
            "ijBn,j->iBn", rho.re, ubi
        )
        # p_b = u_b . v (real part; rho Hermitian makes it real)
        pb = jnp.einsum("i,iBn->Bn", ubr, vr) - jnp.einsum(
            "i,iBn->Bn", ubi, vi
        )
        probs.append(pb)  # (B=a, N)
    out = jnp.stack(probs, axis=-1)  # (a, N, b)
    return jnp.transpose(out, (1, 0, 2))  # (N, a, b)
