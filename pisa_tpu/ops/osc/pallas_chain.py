"""
GPU kernel (Pallas, Triton route) for the matter-oscillation layer chain.

The hot path of the standard three-flavour oscillation stage (cf. reference
``pisa/stages/osc/prob3numba/numba_osc_kernels.py:122`` --
``osc_probs_layers_kernel``, which the reference also runs as a per-thread
CUDA kernel): for every grid point, build each Earth layer's transition
amplitude (matter Hamiltonian -> analytic eigenvalues -> Barger et al.
eq. 10), accumulate the ordered chain product, rotate to the flavour basis
and take squared magnitudes.

Why a kernel: the XLA formulation (:func:`pisa_tpu.ops.osc.kernels.
_osc_probs_xla`) materialises ``(L, 3, 3, N)`` split-complex intermediates
in device memory, and its gradient is reverse mode through the layer scan.
Here one thread owns one point: the whole per-layer algebra stays in
registers, device-memory traffic is the inputs plus the ``(2, 3)``
probability rows per point, and gradients are forward-mode tangents (one
launch per *free* oscillation parameter).

Layout, chosen for the card:

- 1-D blocks of ``BLOCK`` points; geometry in layer-major ``(L, N)`` slabs,
  so each layer's load is coalesced across a block.
- points are sorted by chain length at setup, so the points of a block
  (and of a warp) share the layer-loop trip count; each block reads its
  own bound from an int32 array (most chains are far shorter than the
  padded layer count: 2 slots for the downgoing sky vs ~24 through the
  core; cf. the reference's in-kernel layer cache,
  ``numba_osc_kernels.py:224-271``).
- sorted blocks are interleaved in ``MESH_GROUPS`` groups, so any 1/2/4/8-way
  split of the point axis (``shard_map`` over a device mesh) gets an equal
  mix of short and long chains.
- both neutrino signs run in one launch on a leading grid axis (the kernel
  is sign-independent: the sign is folded into the packed parameters).
- the 57 packed physics scalars (padded to ``PARAM_SLOTS``) are plain loads.
- the layer loop is not unrolled: building two layers' transition matrices
  per iteration measured slower for the tangent launches (register
  pressure) and no faster for the primal (PERF.md).

Algebra (identical math to the XLA path, fewer operations):

- **mass basis.** The vacuum term is ``diag(0, dm21, dm31)/2E``; the matter
  and LRI terms are constant matrices ``M_eff = U^dagger M U`` /
  ``L_eff`` packed outside the kernel, so the per-layer Hamiltonian is
  ``H = diag/2E + a(rho) M_eff + L_eff``. The rotation to the flavour
  basis happens once per point, not once per layer.
- **Hermitian triangles**: only the 3 real diagonals and 3 complex upper
  entries of H and the projector products are formed.
- **shared spectral projectors with a partition of unity**:
  ``T = I + (e^{i ar1} - 1) inv1 Pr1 + (e^{i ar2} - 1) inv2 Pr2``, with the
  eigenvalue differences subtracted before any multiplication.
- the vacuum-matched eigenvalue ordering is layer-invariant and computed
  once per point.
- only the nu_e / nu_mu initial states are propagated; the tau row of the
  probability matrix follows from double stochasticity.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton
from jax.sharding import PartitionSpec as P

from pisa_tpu.ops.cplx import C
from pisa_tpu.ops.osc.kernels import (
    HBAR_C_FACTOR,
    TWO_SQRT2_GF,
    mat_conj_T,
    mat_mul,
)

__all__ = [
    "osc_probs_planar",
    "prepare_chain_geometry",
    "target_platform",
    "use_chain_kernel",
]

# Points and warps per program, swept once on the card at flagship shapes
# (benchmarks/osc_kernel_probe.py --sweep; numbers in PERF.md).
BLOCK = 64
NUM_WARPS = 2
# sorted blocks are interleaved in this many groups (any mesh whose size
# divides it gets balanced shards of the point axis)
MESH_GROUPS = 8
N_PARAMS = 57
PARAM_SLOTS = 64  # N_PARAMS padded to a power of two


def target_platform():
    """The platform a computation traced now is compiled for: the default
    device's (``jax.default_device``, as host-routed fits set it), else the
    default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def use_chain_kernel(platform, dtype, standard_physics):
    """Whether the oscillation stage runs this kernel: only compiled for a
    GPU, in float32, for standard three-flavour matter physics (no decay,
    NSI, LRI or layer dedup). Everything else runs the XLA formulation."""
    return (
        platform == "gpu"
        and jnp.dtype(dtype) == jnp.float32
        and bool(standard_physics)
    )


# ---------------------------------------------------------------------------
# Per-point algebra (pure jnp on (BLOCK,) values; shared by the primal and
# the in-kernel forward-mode tangent)
# ---------------------------------------------------------------------------
def _unpack_params(pv):
    """Packed 57-scalar tuple -> (U, M_eff, L_eff, dm00, dm10, dm20).

    Layout: U re/im at 0/9, M_eff re/im at 18/27, L_eff re/im at 36/45,
    dm_vac[:, 0] at 54..56."""
    U = [
        [C(pv[3 * i + j], pv[9 + 3 * i + j]) for j in range(3)]
        for i in range(3)
    ]
    Me = [
        [C(pv[18 + 3 * i + j], pv[27 + 3 * i + j]) for j in range(3)]
        for i in range(3)
    ]
    Le = [
        [C(pv[36 + 3 * i + j], pv[45 + 3 * i + j]) for j in range(3)]
        for i in range(3)
    ]
    return U, Me, Le, pv[54], pv[55], pv[56]


def _flat12(v):
    """Two propagated state columns (nested [a][i] of C) -> flat 12-tuple."""
    return tuple(v[a][i].re for a in range(2) for i in range(3)) + tuple(
        v[a][i].im for a in range(2) for i in range(3)
    )


def _unflat12(t):
    return [
        [C(t[3 * a + i], t[6 + 3 * a + i]) for i in range(3)]
        for a in range(2)
    ]


def _econ(e):
    """Energy-derived per-point constants (parameter-independent)."""
    dtype = e.dtype
    return dict(
        one_over_two_e=0.5 / e,
        two_e=2.0 * e,
        phase_s=-(1.0 / e) * HBAR_C_FACTOR,  # * baseline, applied per layer
        tiny=jnp.asarray(1e-30, dtype=dtype),
        ones=jnp.ones_like(e),
    )


def _cubic_roots(scale, b, c2, res, two_e, dm00):
    """The three eigenvalues (2E-scaled, shifted by dm00) from the
    trigonometric solution of the normalised characteristic cubic."""
    third = 1.0 / 3.0
    cr, sr = jnp.cos(res), jnp.sin(res)
    half_sqrt3 = 0.8660254037844386
    # cos(res +- 2pi/3) via angle addition: 2 transcendentals, not 3
    return [
        two_e * (scale * (b * (-0.5 * cr - half_sqrt3 * sr) - c2 * third)
                 + dm00),
        two_e * (scale * (b * (-0.5 * cr + half_sqrt3 * sr) - c2 * third)
                 + dm00),
        two_e * (scale * (b * cr - c2 * third) + dm00),
    ]


def _vacuum_picks(pv, econ):
    """Vacuum-matched ordering masks for the in-matter eigenvalues
    (cf. kernels._dms_soa_scalars vacuum branch / numba_osc_kernels.py:688).
    Layer-invariant, and non-differentiable by construction (argmin
    selection)."""
    dm00, dm10, dm20 = pv[54], pv[55], pv[56]
    one_over_two_e = econ["one_over_two_e"]
    third = 1.0 / 3.0
    scale_v = jnp.maximum(
        jnp.maximum(jnp.abs(dm10), jnp.abs(dm20)) * one_over_two_e,
        econ["tiny"],
    )
    x = dm10 * one_over_two_e / scale_v
    y = dm20 * one_over_two_e / scale_v
    c2_v = -(x + y)
    p_v = x * x + y * y - x * y
    q_v = (x + y) * ((x + y) ** 2 - 4.5 * x * y)
    tmp_v = jnp.maximum(p_v * p_v * p_v - q_v * q_v, 0.0)
    res_v = jnp.arctan2(jnp.sqrt(tmp_v), q_v) * third
    b_v = (2.0 * third) * jnp.sqrt(p_v)
    m_v = _cubic_roots(scale_v, b_v, c2_v, res_v, econ["two_e"], dm00)
    # selection masks: m[i] = m_u[argmin_j |dm_vac[i,0] - m_v[j]|]
    picks = []
    for target in (dm00, dm10, dm20):
        d0 = jnp.abs(target - m_v[0])
        d1 = jnp.abs(target - m_v[1])
        d2 = jnp.abs(target - m_v[2])
        picks.append((d1 < d0, d2 < jnp.minimum(d0, d1)))
    return picks


def _init_carry(pv, econ):
    """Initial states: |nu_a> rotated to the mass basis, i.e. column a of
    U^dagger: v_a[i] = conj(U[a][i])."""
    U = _unpack_params(pv)[0]
    ones = econ["ones"]
    return _flat12(
        [
            [C(U[a][i].re * ones, -U[a][i].im * ones) for i in range(3)]
            for a in range(2)
        ]
    )


def _layer_T(pv, rho, dx, econ, picks):
    """One layer's transition matrix: (T, keep) where T is the nested 3x3
    of C (Barger eq. 10 amplitude up to a global phase) and `keep` the
    dx > 0 mask (zero-length layers act as identity in :func:`_apply_T`)."""
    _, Me, Le, dm00, dm10, dm20 = _unpack_params(pv)
    one_over_two_e = econ["one_over_two_e"]
    two_e = econ["two_e"]
    third = 1.0 / 3.0

    a = (0.5 * TWO_SQRT2_GF) * rho

    # mass-basis Hamiltonian, Hermitian triangle:
    # H = diag(0, dm21, dm31)/2E + a*M_eff + L_eff
    def offd(i, j):
        return C(
            Me[i][j].re * a + Le[i][j].re, Me[i][j].im * a + Le[i][j].im
        )

    h01, h02, h12 = offd(0, 1), offd(0, 2), offd(1, 2)
    h00 = Me[0][0].re * a + Le[0][0].re
    h11 = Me[1][1].re * a + Le[1][1].re + dm10 * one_over_two_e
    h22 = Me[2][2].re * a + Le[2][2].re + dm20 * one_over_two_e

    # ---- eigenvalues: char-poly coefficients (basis-invariant),
    # scale-normalised on the coefficients (cf. numba_osc_kernels.py:688)
    n01, n02, n12 = h01.abs2(), h02.abs2(), h12.abs2()
    scale2 = jnp.maximum(
        jnp.maximum(jnp.maximum(h00 * h00, h11 * h11), h22 * h22),
        jnp.maximum(jnp.maximum(n01, n02), n12),
    )
    # one rsqrt replaces sqrt + divide (the floor guards exact-zero H;
    # 1e-36 stays normal in fp32)
    scale2 = jnp.maximum(scale2, jnp.asarray(1e-36, dtype=scale2.dtype))
    inv_s = jax.lax.rsqrt(scale2)
    scale = scale2 * inv_s
    inv_s2 = inv_s * inv_s

    real_product_a = (
        h01.re * (h12.re * h02.re + h12.im * h02.im)
        - h01.im * (h12.im * h02.re - h12.re * h02.im)
    )  # Re(H01 H12 conj(H02)) = Re(H01 H12 H20)
    c2 = -(h00 + h11 + h22) * inv_s
    c1 = (h00 * (h11 + h22) + h11 * h22 - n01 - n02 - n12) * inv_s2
    c0 = (
        (h00 * n12 + h11 * n02 + h22 * n01)
        - 2.0 * real_product_a
        - h00 * h11 * h22
    ) * (inv_s2 * inv_s)

    pp = jnp.maximum(c2 * c2 - 3.0 * c1, 0.0)
    qq = -13.5 * c0 - c2 * c2 * c2 + 4.5 * c1 * c2
    tmp = jnp.maximum(
        27.0 * (0.25 * c1 * c1 * (pp - c1) + c0 * (qq + 6.75 * c0)), 0.0
    )
    res = jnp.arctan2(jnp.sqrt(tmp), qq) * third
    b = (2.0 * third) * jnp.sqrt(pp)
    m_u = _cubic_roots(scale, b, c2, res, two_e, dm00)
    m = []
    for pick1, pick2 in picks:
        best01 = jnp.where(pick1, m_u[1], m_u[0])
        m.append(jnp.where(pick2, m_u[2], best01))

    # ---- Barger eq. 10 via spectral projectors over the 2E-scaled
    # Hamiltonian G: the two factors of each (G - m_a)(G - m_b) commute,
    # so each product is exactly Hermitian, and eigenvalue differences are
    # subtracted before any multiplication (an alpha0 + alpha1 G +
    # alpha2 G^2 expansion loses ~1e-4 to cancellation at near-degenerate
    # eigenvalues) ----
    g00, g11, g22 = h00 * two_e, h11 * two_e, h22 * two_e
    g01 = C(h01.re * two_e, h01.im * two_e)
    g02 = C(h02.re * two_e, h02.im * two_e)
    g12 = C(h12.re * two_e, h12.im * two_e)

    # cross terms and norms shared by both projector products
    n01g, n02g, n12g = g01.abs2(), g02.abs2(), g12.abs2()
    x01 = g02 * g12.conj()
    x02 = g01 * g12
    x12 = g01.conj() * g02

    def projector(ma, mb):
        """(G - ma)(G - mb), Hermitian triangle (d0,d1,d2,o01,o02,o12)."""
        a00, a11, a22 = g00 - ma, g11 - ma, g22 - ma
        b00, b11, b22 = g00 - mb, g11 - mb, g22 - mb
        return (
            a00 * b00 + n01g + n02g,
            a11 * b11 + n01g + n12g,
            a22 * b22 + n02g + n12g,
            C(g01.re * (a00 + b11), g01.im * (a00 + b11)) + x01,
            C(g02.re * (a00 + b22), g02.im * (a00 + b22)) + x02,
            C(g12.re * (a11 + b22), g12.im * (a11 + b22)) + x12,
        )

    Pr1 = projector(m[0], m[2])
    Pr2 = projector(m[0], m[1])

    d01 = m[0] - m[1]
    d02 = m[0] - m[2]
    d12 = m[1] - m[2]
    # one reciprocal serves both spectral weights:
    # inv1 = 1/((m1-m0)(m1-m2)) = -d02*r, inv2 = 1/((m2-m0)(m2-m1)) = d01*r
    r = 1.0 / (d01 * d02 * d12)
    inv1 = -d02 * r
    inv2 = d01 * r

    s = econ["phase_s"] * dx

    # Only phase differences survive |.|^2 of the chain product, so T is
    # computed up to the global phase e^{i m0 s}. The projectors form a
    # partition of unity, so Barger eq. 10 collapses to
    #   T = I + (e^{i ar1} - 1) inv1 Pr1 + (e^{i ar2} - 1) inv2 Pr2
    # and Pr0 is never formed.
    ar1 = -d01 * s  # (m1 - m0) s
    ar2 = -d02 * s  # (m2 - m0) s
    w1 = C((jnp.cos(ar1) - 1.0) * inv1, jnp.sin(ar1) * inv1)
    w2 = C((jnp.cos(ar2) - 1.0) * inv2, jnp.sin(ar2) * inv2)

    def tdiag(idx):
        v = w1 * Pr1[idx] + w2 * Pr2[idx]
        return C(v.re + 1.0, v.im)

    def toffd(idx, conjugate=False):
        b_, c_ = Pr1[idx], Pr2[idx]
        if conjugate:
            b_, c_ = b_.conj(), c_.conj()
        return w1 * b_ + w2 * c_

    T = [
        [tdiag(0), toffd(3), toffd(4)],
        [toffd(3, True), tdiag(1), toffd(5)],
        [toffd(4, True), toffd(5, True), tdiag(2)],
    ]
    return T, dx > 0.0


def _apply_T(T, keep, V):
    """Chain product on the two state columns: v <- T @ v; masked
    (zero-length) layers act as identity."""
    newV = []
    for a_idx in range(2):
        col = []
        for i in range(3):
            acc = (
                T[i][0] * V[a_idx][0]
                + T[i][1] * V[a_idx][1]
                + T[i][2] * V[a_idx][2]
            )
            col.append(
                C(
                    jnp.where(keep, acc.re, V[a_idx][i].re),
                    jnp.where(keep, acc.im, V[a_idx][i].im),
                )
            )
        newV.append(col)
    return newV


def _final_probs(carry, pv):
    """Back to the flavour basis and squared magnitudes:
    F[b][a] = (U v_a)[b]; returns nested [a][b] |F|^2."""
    U = _unpack_params(pv)[0]
    V = _unflat12(carry)
    return [
        [
            (U[b][0] * V[a][0] + U[b][1] * V[a][1] + U[b][2] * V[a][2]).abs2()
            for b in range(3)
        ]
        for a in range(2)
    ]


def _chain_block_math(pv, nl, e, dens_get, dist_get):
    """Full layer-chain propagation for one block of points, as a pure
    function of the packed parameter scalars `pv` (so the tangent kernel
    can differentiate it with an in-body ``jax.jvp``). ``nl`` is the
    block's layer-loop bound, ``e`` the (BLOCK,) energies, and
    ``dens_get(l)`` / ``dist_get(l)`` load layer l's (BLOCK,) slab.
    Returns nested ``[a][b]`` |amplitude|^2 (a = initial nu_e/nu_mu state,
    b = final flavour)."""
    econ = _econ(e)
    picks = _vacuum_picks(pv, econ)

    def body(layer, carry):
        T, keep = _layer_T(pv, dens_get(layer), dist_get(layer), econ, picks)
        return _flat12(_apply_T(T, keep, _unflat12(carry)))

    carry = jax.lax.fori_loop(0, nl, body, _init_carry(pv, econ))
    return _final_probs(carry, pv)


# ---------------------------------------------------------------------------
# Kernels and launch
# ---------------------------------------------------------------------------
def _store(out_ref, vals):
    for a in range(2):
        for b in range(3):
            out_ref[a, b, :] = vals[a][b]


def _chain_kernel(pp_ref, nl_ref, e_ref, dens_ref, dist_ref, out_ref):
    """Primal: one block of points for one neutrino sign."""
    pv = tuple(pp_ref[k] for k in range(N_PARAMS))
    _store(
        out_ref,
        _chain_block_math(
            pv, nl_ref[...], e_ref[...],
            lambda l: dens_ref[l, :], lambda l: dist_ref[l, :],
        ),
    )


def _tangent_kernel(pp_ref, dpp_ref, nl_ref, e_ref, dens_ref, dist_ref,
                    dout_ref):
    """Forward-mode tangent d(probs)/dt along one direction `dpp` of the
    packed parameters: an in-body ``jax.jvp`` of the primal block math.
    Geometry loads carry zero tangent."""
    nl = nl_ref[...]
    e = e_ref[...]
    pv = tuple(pp_ref[k] for k in range(N_PARAMS))
    dpv = tuple(dpp_ref[k] for k in range(N_PARAMS))

    def fn(pvt):
        return _chain_block_math(
            pvt, nl, e, lambda l: dens_ref[l, :], lambda l: dist_ref[l, :]
        )

    _, dvals = jax.jvp(fn, (pv,), (dpv,))
    _store(dout_ref, dvals)


def _launch(kernel, params, nl, e, dens, dist, *, interpret):
    """pallas_call of `kernel` over the prepared (layout-order) geometry.
    `params`: list of (S, PARAM_SLOTS) packed vectors (one row per
    neutrino sign). Returns (S, 2, 3, n_pad)."""
    n_signs = params[0].shape[0]
    n_layers, n_pad = dens.shape
    n_blocks = nl.shape[0]
    block = n_pad // n_blocks
    pspec = pl.BlockSpec((None, PARAM_SLOTS), lambda s, b: (s, 0))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_signs, 2, 3, n_pad), e.dtype),
        grid=(n_signs, n_blocks),
        in_specs=[pspec] * len(params) + [
            pl.BlockSpec((None,), lambda s, b: (b,)),
            pl.BlockSpec((block,), lambda s, b: (b,)),
            pl.BlockSpec((n_layers, block), lambda s, b: (0, b)),
            pl.BlockSpec((n_layers, block), lambda s, b: (0, b)),
        ],
        out_specs=pl.BlockSpec(
            (None, 2, 3, block), lambda s, b: (s, 0, 0, b)
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=kernel.__name__.lstrip("_"),
    )(*params, nl, e, dens, dist)


def _run(kernel, params, geom, *, interpret, mesh, axis_name):
    """Launch over the whole point axis, or -- with a mesh whose size
    divides the block interleave -- under ``shard_map`` over `axis_name`,
    each device running its own contiguous share of the blocks (the
    kernel is pointwise; without this XLA replicates the custom call)."""
    args = (geom["nl"], geom["e"], geom["dens"], geom["dist"])
    run = partial(_launch, kernel, interpret=interpret)
    n_dev = 1 if mesh is None else mesh.shape[axis_name]
    if n_dev == 1 or geom["nl"].shape[0] % n_dev:
        return run(list(params), *args)
    ax = axis_name
    return jax.shard_map(
        lambda ps, *g: run(list(ps), *g),
        mesh=mesh,
        in_specs=(
            tuple(P() for _ in params), P(ax), P(ax), P(None, ax),
            P(None, ax),
        ),
        out_specs=P(None, None, None, ax),
        check_vma=False,
    )(tuple(params), *args)


# ---------------------------------------------------------------------------
# Geometry preparation (host, once at stage setup)
# ---------------------------------------------------------------------------
def prepare_chain_geometry(energy, densities, distances, block=BLOCK):
    """Every parameter-independent kernel input, computed once on the host
    from the static geometry: points sorted by chain length, cut into
    blocks of `block`, the sorted blocks interleaved in ``MESH_GROUPS``
    groups, and laid out layer-major.

    Returns a dict of numpy arrays: ``e`` (n_pad,), ``dens``/``dist``
    (L, n_pad), ``nl`` (n_blocks,) int32 per-block layer bounds, and
    ``inv`` (n,) int32, the layout position of each original point.
    Padding points have E = 1 GeV and zero-length chains."""
    energy = np.asarray(energy)
    densities = np.asarray(densities)
    distances = np.asarray(distances)
    n, n_layers = distances.shape
    real = distances > 0.0
    # per-point loop bound: 1 + index of the last nonzero-length layer
    bound = np.where(
        real.any(axis=1), n_layers - np.argmax(real[:, ::-1], axis=1), 0
    )
    order = np.argsort(bound, kind="stable")
    n_blocks = max(1, -(-n // (block * MESH_GROUPS))) * MESH_GROUPS
    n_pad = n_blocks * block
    # sorted slot j sits in sorted block j // block; block b is placed at
    # (b % MESH_GROUPS) * (n_blocks // MESH_GROUPS) + b // MESH_GROUPS
    j = np.arange(n_pad)
    b = j // block
    pos = (
        (b % MESH_GROUPS) * (n_blocks // MESH_GROUPS) + b // MESH_GROUPS
    ) * block + j % block
    src = np.full(n_pad, -1, dtype=np.int64)
    src[pos[:n]] = order
    inv = np.empty(n, dtype=np.int32)
    inv[order] = pos[:n]
    valid = src >= 0

    e = np.ones(n_pad, dtype=energy.dtype)
    e[valid] = energy[src[valid]]
    dens = np.zeros((n_layers, n_pad), dtype=densities.dtype)
    dist = np.zeros((n_layers, n_pad), dtype=distances.dtype)
    dens[:, valid] = densities[src[valid]].T
    dist[:, valid] = distances[src[valid]].T
    bound_pad = np.zeros(n_pad, dtype=np.int32)
    bound_pad[valid] = bound[src[valid]]
    nl = bound_pad.reshape(n_blocks, block).max(axis=1).astype(np.int32)
    return dict(e=e, dens=dens, dist=dist, nl=nl, inv=inv)


# ---------------------------------------------------------------------------
# Physics packing and the differentiable entry point
# ---------------------------------------------------------------------------
def _pack_params(U, M_eff, L_eff, dm_vac, dtype):
    """(PARAM_SLOTS,) vector: U(re,im) | M_eff(re,im) | L_eff(re,im) |
    dm_vac[:, 0] | zero padding."""
    parts = [
        U.re.reshape(-1),
        U.im.reshape(-1),
        M_eff.re.reshape(-1),
        M_eff.im.reshape(-1),
        L_eff.re.reshape(-1),
        L_eff.im.reshape(-1),
        jnp.asarray(dm_vac)[:, 0].reshape(-1),
        jnp.zeros((PARAM_SLOTS - N_PARAMS,)),
    ]
    return jnp.concatenate(
        [jnp.asarray(x, dtype=dtype).reshape(-1) for x in parts]
    )


def _pack_sign(theta, nubar, reparam, nlo_factor, lri_pot, dtype):
    """theta = (theta12, theta13, theta23, deltacp, dm21, dm31) [rad, eV^2]
    -> packed kernel parameters for one neutrino sign (standard matter
    potential with the NLO factor; `lri_pot`, a constant real 3x3 LRI
    potential in eV as a flat 9-tuple, or None). The mass-basis matter and
    LRI terms take the nubar sign, so the kernel itself is
    sign-independent."""
    from pisa_tpu.ops.osc.kernels import mat_of, mat_to_C, smat_view
    from pisa_tpu.ops.osc.pmns import (
        dm_matrix,
        pmns_matrix,
        pmns_matrix_reparam,
    )

    t12, t13, t23, dcp, dm21, dm31 = (theta[i] for i in range(6))
    fn = pmns_matrix_reparam if reparam else pmns_matrix
    mix = fn(jnp.sin(t12), jnp.sin(t13), jnp.sin(t23), dcp)
    U = mix if nubar > 0 else mix.conj()
    dm_vac = dm_matrix(dm21, dm31)
    Um = smat_view(U)
    # flavour-basis matter potential per unit a: diag(nlo, 0, 0) for nu,
    # its negative for nubar, rotated to the mass basis
    mp = mat_of(C.of(np.diag([nubar * float(nlo_factor), 0.0, 0.0])))
    M_eff = mat_to_C(mat_mul(mat_mul(mat_conj_T(Um), mp), Um))
    # LRI potential [eV] in the Hamiltonian's eV^2/GeV units, sign-flipped
    # for nubar (cf. kernels.get_H_mat)
    lri = np.zeros(9) if lri_pot is None else np.asarray(lri_pot)
    lm = mat_of(C.of((nubar * 1e9) * lri.reshape(3, 3)))
    L_eff = mat_to_C(mat_mul(mat_mul(mat_conj_T(Um), lm), Um))
    return _pack_params(U, M_eff, L_eff, dm_vac, dtype)


def _pack(theta, signs, reparam, nlo_factor, lri_pot, dtype):
    return jnp.stack([
        _pack_sign(theta, s, reparam, nlo_factor, lri_pot, dtype)
        for s in signs
    ])


@partial(jax.custom_jvp, nondiff_argnums=(0, 1, 2, 3, 4, 5, 6, 7))
def _probs_planar(signs, reparam, nlo_factor, lri_pot, active, mesh,
                  axis_name, interpret, theta, geom):
    pvecs = _pack(theta, signs, reparam, nlo_factor, lri_pot,
                  geom["e"].dtype)
    out = _run(_chain_kernel, [pvecs], geom, interpret=interpret,
               mesh=mesh, axis_name=axis_name)
    return out[..., geom["inv"]]


@_probs_planar.defjvp
def _probs_planar_jvp(signs, reparam, nlo_factor, lri_pot, active, mesh,
                      axis_name, interpret, primals, tangents):
    """One tangent launch per active component k of theta (the fit's free
    oscillation parameters) gives the column J_k = d(probs)/d(theta_k);
    the output tangent is sum_k dtheta_k J_k. The J_k depend on the
    primals only, so the rule is linear in dtheta: JAX transposes it for
    reverse mode, and forward mode (``jacfwd``) uses it directly. An
    inactive component contributes nothing. Geometry is constant."""
    theta, geom = primals
    dtheta = tangents[0]
    dtype = geom["e"].dtype

    def pack(th):
        return _pack(th, signs, reparam, nlo_factor, lri_pot, dtype)

    def run(kernel, params):
        out = _run(kernel, params, geom, interpret=interpret, mesh=mesh,
                   axis_name=axis_name)
        return out[..., geom["inv"]]

    pvecs = pack(theta)
    out = run(_chain_kernel, [pvecs])
    jac = jax.jacfwd(pack)(theta)  # (S, PARAM_SLOTS, 6)
    dout = jnp.zeros_like(out)
    for k in active:
        dout = dout + dtheta[k].astype(dtype) * run(
            _tangent_kernel, [pvecs, jac[..., k]]
        )
    return out, dout


def osc_probs_planar(theta, signs, geom, reparam=False, nlo_factor=1.0,
                     lri_pot=None, active=None, mesh=None, axis_name="data",
                     interpret=False):
    """Standard-path oscillation probabilities over prepared geometry
    (:func:`prepare_chain_geometry`), differentiable in ``theta`` =
    (theta12, theta13, theta23, deltacp, dm21, dm31) by forward-mode
    tangents in forward and reverse mode. `lri_pot` (optional, concrete
    real 3x3 in eV) is a constant long-range-interaction potential; it is
    not differentiated.

    Returns ``(len(signs), 2, 3, n)``: (neutrino sign, initial state
    e/mu, final flavour, point), the point axis last. `signs` is a static
    tuple of +1 (nu) / -1 (nubar). `active` (static tuple of theta indices,
    default all) limits the tangent launches to those components; the
    others get zero derivative. With a `mesh`, the launches run under
    ``shard_map`` over `axis_name`. `interpret=True` runs the kernel body
    through the Pallas interpreter (for tests off the card)."""
    if active is None:
        active = tuple(range(6))
    geom = {k: jnp.asarray(v) for k, v in geom.items()}
    if lri_pot is not None:
        lri_pot = tuple(float(x) for x in np.ravel(lri_pot))
    return _probs_planar(
        tuple(int(s) for s in signs), bool(reparam), float(nlo_factor),
        lri_pot, tuple(int(i) for i in active), mesh, axis_name,
        bool(interpret),
        jnp.asarray(theta, dtype=geom["e"].dtype), geom,
    )
