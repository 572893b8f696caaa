"""
GPU chain kernel (ops/osc/pallas_chain.py) vs the XLA oscillation path.

Off the card the kernel body runs through the Pallas interpreter
(``interpret=True``), so the algebra (mass basis, Hermitian triangles,
shared spectral projectors), the prepared layout (chain-length sort, block
interleave, unsort) and the forward-mode tangents are checked against the
XLA implementation that the golden-pickle suite (tests/test_osc_golden.py)
anchors to the reference. Lowering for CUDA is checked here too; the
compiled kernel itself runs in the ``gpu`` lane.
"""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pisa_tpu import FTYPE
from pisa_tpu.ops.cplx import C
from pisa_tpu.ops.osc import pallas_chain as pc
from pisa_tpu.ops.osc.kernels import osc_probs_layers
from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix

_F64 = FTYPE == np.float64
THETA = [0.58, 0.15, 0.78, 1.2, 7.4e-5, 2.5e-3]


def _geometry(n=96, n_layers=6, seed=5, dtype=np.float64):
    """Random chains with heterogeneous lengths (zero-padded tails), as
    the Earth-layer geometry has."""
    rng = np.random.RandomState(seed)
    e = 10 ** rng.uniform(0, 2, n)
    nl = rng.randint(1, n_layers + 1, n)
    dens = rng.uniform(1, 10, (n, n_layers))
    dist = rng.uniform(50, 1000, (n, n_layers))
    for i, k in enumerate(nl):
        dens[i, k:] = 0.0
        dist[i, k:] = 0.0
    return e.astype(dtype), dens.astype(dtype), dist.astype(dtype)


def _xla_planar(theta, signs, e, dens, dist):
    """The XLA formulation in the kernel's (sign, init, final, point)
    layout."""
    mix = pmns_matrix(
        jnp.sin(theta[0]), jnp.sin(theta[1]), jnp.sin(theta[2]), theta[3]
    )
    dm = dm_matrix(theta[4], theta[5])
    mat_pot = C.of(np.diag([1.0, 0.0, 0.0]).astype(np.complex128))
    mat_decay = C.of(np.zeros((3, 3), np.complex128))
    lri = np.zeros((3, 3))
    return jnp.stack([
        osc_probs_layers(
            dm, mix, mat_pot, mat_decay, lri, s, jnp.asarray(e),
            jnp.asarray(dens), jnp.asarray(dist),
        )[:, :2, :].transpose(1, 2, 0)
        for s in signs
    ])


def _kernel(theta, signs, geom, **kw):
    return pc.osc_probs_planar(
        jnp.asarray(theta), signs, geom, interpret=True, **kw
    )


# fp64 agreement is at the level of the two formulations' rounding; fp32
# at the chain-product level
_ATOL = 1e-12 if _F64 else 2e-5


@pytest.mark.parametrize("nubar", [1, -1])
def test_matches_xla_path(nubar):
    e, dens, dist = _geometry(seed=7)
    geom = pc.prepare_chain_geometry(e, dens, dist)
    out = np.asarray(_kernel(THETA, (nubar,), geom))
    ref = np.asarray(_xla_planar(jnp.asarray(THETA), (nubar,), e, dens, dist))
    assert out.shape == ref.shape == (1, 2, 3, e.size)
    np.testing.assert_allclose(out, ref, atol=_ATOL)
    # rows of |U|^2 are probability distributions
    np.testing.assert_allclose(out.sum(axis=2), 1.0, atol=_ATOL)


def test_both_signs_one_launch():
    """Both neutrino signs on the launch's leading grid axis equal two
    single-sign launches."""
    e, dens, dist = _geometry(seed=9)
    geom = pc.prepare_chain_geometry(e, dens, dist)
    both = np.asarray(_kernel(THETA, (1, -1), geom))
    for i, s in enumerate((1, -1)):
        one = np.asarray(_kernel(THETA, (s,), geom))
        np.testing.assert_array_equal(both[i], one[0])


def test_odd_sizes_padding():
    """A point count that fills no whole block pads transparently."""
    e, dens, dist = _geometry(n=96, seed=11)
    full = np.asarray(
        _kernel(THETA, (1,), pc.prepare_chain_geometry(e, dens, dist))
    )
    part = np.asarray(
        _kernel(
            THETA, (1,),
            pc.prepare_chain_geometry(e[:77], dens[:77], dist[:77]),
        )
    )
    assert part.shape == (1, 2, 3, 77)
    np.testing.assert_allclose(part, full[..., :77], atol=1e-14 if _F64 else 1e-6)


def test_chain_order_permutation_invariance():
    """Points are evaluated in chain-length order and interleaved blocks;
    the result comes back in the original point order."""
    e, dens, dist = _geometry(n=300, n_layers=8, seed=13)
    geom = pc.prepare_chain_geometry(e, dens, dist, block=16)
    perm = np.random.RandomState(1).permutation(e.size)
    geom_p = pc.prepare_chain_geometry(e[perm], dens[perm], dist[perm],
                                       block=16)
    out = np.asarray(_kernel(THETA, (1,), geom))
    out_p = np.asarray(_kernel(THETA, (1,), geom_p))
    np.testing.assert_allclose(out_p, out[..., perm], atol=1e-14 if _F64 else 1e-6)
    ref = np.asarray(_xla_planar(jnp.asarray(THETA), (1,), e, dens, dist))
    np.testing.assert_allclose(out, ref, atol=_ATOL)


def test_prepare_geometry_layout():
    """Host-side layout: per-block bounds cover every chain of the block,
    the unsort index round-trips, padding points are identity chains at
    E = 1 GeV, and any 1/2/4/8-way split of the blocks gets the same mix of
    chain lengths."""
    e, dens, dist = _geometry(n=1000, n_layers=7, seed=3)
    block = 8
    g = pc.prepare_chain_geometry(e, dens, dist, block=block)
    n_pad = g["e"].shape[0]
    n_blocks = g["nl"].shape[0]
    assert n_pad == n_blocks * block and n_blocks % pc.MESH_GROUPS == 0
    assert g["dens"].shape == g["dist"].shape == (7, n_pad)
    # the unsort index maps each original point to its layout slot
    np.testing.assert_array_equal(g["e"][g["inv"]], e)
    np.testing.assert_array_equal(g["dist"][:, g["inv"]], dist.T)
    np.testing.assert_array_equal(g["dens"][:, g["inv"]], dens.T)
    pad = np.ones(n_pad, bool)
    pad[g["inv"]] = False
    assert np.all(g["e"][pad] == 1.0) and np.all(g["dist"][:, pad] == 0.0)
    # per-block bound = 1 + last real layer of the block's longest chain
    real = g["dist"] > 0
    last = np.where(
        real.any(0), real.shape[0] - np.argmax(real[::-1], axis=0), 0
    )
    np.testing.assert_array_equal(
        g["nl"], last.reshape(n_blocks, block).max(axis=1)
    )
    # sorted blocks are nearly homogeneous: the padding a block's bound
    # forces is a small share of the work
    assert last.sum() / (g["nl"].sum() * block) > 0.8
    # balanced shards: each device's share of the block bounds is even
    for n_dev in (2, 4, 8):
        shares = g["nl"].reshape(n_dev, -1).sum(axis=1)
        assert shares.max() - shares.min() <= 0.05 * shares.mean() + 7


def test_fwdgrad_values_and_gradients():
    """Forward-mode tangents (one launch per theta component) reproduce
    the XLA reverse-mode gradient of a weighted sum over both signs."""
    e, dens, dist = _geometry(n=96, seed=3)
    geom = pc.prepare_chain_geometry(e, dens, dist)
    theta = jnp.asarray(THETA)
    w = jnp.asarray(np.random.RandomState(3).uniform(-1, 1, (2, 2, 3, 96)))

    g_kernel = np.asarray(jax.grad(
        lambda th: jnp.sum(w * _kernel(th, (1, -1), geom))
    )(theta))
    g_xla = np.asarray(jax.grad(
        lambda th: jnp.sum(w * _xla_planar(th, (1, -1), e, dens, dist))
    )(theta))
    assert np.abs(g_kernel - g_xla).max() / np.abs(g_xla).max() < (
        1e-10 if _F64 else 5e-5
    )


def test_fwdgrad_prepared_active_subset():
    """With active=(1, 2, 5) only those components get tangent launches:
    they match the XLA gradient, the others are exactly zero."""
    e, dens, dist = _geometry(n=64, n_layers=5, seed=5)
    geom = pc.prepare_chain_geometry(e, dens, dist)
    theta = jnp.asarray(THETA)
    w = jnp.asarray(np.random.RandomState(5).uniform(-1, 1, (1, 2, 3, 64)))
    g_act = np.asarray(jax.grad(
        lambda th: jnp.sum(w * _kernel(th, (-1,), geom, active=(1, 2, 5)))
    )(theta))
    g_xla = np.asarray(jax.grad(
        lambda th: jnp.sum(w * _xla_planar(th, (-1,), e, dens, dist))
    )(theta))
    np.testing.assert_allclose(
        g_act[[1, 2, 5]], g_xla[[1, 2, 5]], rtol=1e-9 if _F64 else 5e-5
    )
    assert np.all(g_act[[0, 3, 4]] == 0.0)
    assert np.abs(g_xla[[0, 3, 4]]).max() > 0  # the full gradient differs


def test_jacfwd_matches_xla():
    """Forward mode (``jax.jacfwd``, as the Fisher matrix takes it) runs
    the same tangent launches: the active columns of the per-point
    jacobian equal the XLA path's, the inactive ones are zero."""
    e, dens, dist = _geometry(n=48, n_layers=5, seed=23)
    geom = pc.prepare_chain_geometry(e, dens, dist)
    theta = jnp.asarray(THETA)
    j_k = np.asarray(jax.jacfwd(
        lambda th: _kernel(th, (1, -1), geom, active=(1, 2, 5))
    )(theta))
    j_x = np.asarray(jax.jacfwd(
        lambda th: _xla_planar(th, (1, -1), e, dens, dist)
    )(theta))
    assert j_k.shape == j_x.shape == (2, 2, 3, 48, 6)
    scale = np.abs(j_x[..., [1, 2, 5]]).max()
    assert np.abs(j_k[..., [1, 2, 5]] - j_x[..., [1, 2, 5]]).max() < (
        (1e-10 if _F64 else 5e-5) * scale
    )
    assert np.all(j_k[..., [0, 3, 4]] == 0.0)


def test_vmap_matches_loop():
    """vmap over parameter vectors (the batched objective's access
    pattern) batches the launch and equals a loop of single calls."""
    e, dens, dist = _geometry(n=40, seed=17)
    geom = pc.prepare_chain_geometry(e, dens, dist)
    thetas = jnp.asarray(THETA)[None] * jnp.asarray([[1.0], [0.97], [1.03]])
    batched = np.asarray(jax.vmap(lambda t: _kernel(t, (1,), geom))(thetas))
    for i in range(3):
        np.testing.assert_allclose(
            batched[i], np.asarray(_kernel(thetas[i], (1,), geom)),
            atol=1e-14 if _F64 else 1e-6,
        )


def test_kernel_under_shard_map():
    """With a mesh, each device propagates its share of the blocks
    (shard_map over the point axis) and the result equals the unsharded
    launch."""
    from pisa_tpu.parallel import default_mesh

    e, dens, dist = _geometry(n=200, seed=19)
    geom = pc.prepare_chain_geometry(e, dens, dist, block=8)
    mesh = default_mesh(4)
    f = jax.jit(lambda th, g: _kernel(th, (1, -1), g, mesh=mesh))
    sharded = np.asarray(f(jnp.asarray(THETA), geom))
    plain = np.asarray(_kernel(THETA, (1, -1), geom))
    np.testing.assert_allclose(sharded, plain, atol=1e-14 if _F64 else 1e-6)
    lowered = f.lower(jnp.asarray(THETA), geom).as_text()
    assert "shard_map" in lowered or "sdy.manual_computation" in lowered


def test_slot_index_compaction_parity():
    """The slot-compacted XLA path (transition algebra only over real
    distance>0 slots, identity-scattered back) must match the padded path
    in values AND parameter gradients at fp64 machine precision."""
    e, dens, dist = _geometry(n=96, n_layers=6, seed=3)
    slot = np.flatnonzero(
        np.swapaxes(dist, 0, 1).ravel() > 0.0
    ).astype(np.int32)
    assert 0 < len(slot) < dist.size
    mix = pmns_matrix(jnp.sin(0.58), jnp.sin(0.15), jnp.sin(0.78), 1.2)
    mat_pot = C.of(np.diag([1.0, 0.0, 0.0]).astype(np.complex128))
    mat_decay = C.of(np.zeros((3, 3), np.complex128))
    lri = np.zeros((3, 3))

    for nubar in (1, -1):
        dm = dm_matrix(7.4e-5, 2.5e-3)
        p0 = np.asarray(osc_probs_layers(
            dm, mix, mat_pot, mat_decay, lri, nubar, e, dens, dist
        ))
        p1 = np.asarray(osc_probs_layers(
            dm, mix, mat_pot, mat_decay, lri, nubar, e, dens, dist,
            slot_index=jnp.asarray(slot),
        ))
        np.testing.assert_allclose(p1, p0, atol=1e-13 if _F64 else 2e-6)

    def loss(dm31, slot_index):
        probs = osc_probs_layers(
            dm_matrix(7.4e-5, dm31), mix, mat_pot, mat_decay, lri, 1,
            jnp.asarray(e), jnp.asarray(dens), jnp.asarray(dist),
            slot_index=slot_index,
        )
        return jnp.sum(probs[:, 1, 1] ** 2)

    g0 = float(jax.grad(lambda d: loss(d, None))(2.5e-3))
    g1 = float(jax.grad(lambda d: loss(d, jnp.asarray(slot)))(2.5e-3))
    assert abs(g1 - g0) <= (1e-10 if _F64 else 2e-5) * abs(g0)


# -- lowering for the card (no GPU needed) -----------------------------------
def _lowering_case(kind):
    e, dens, dist = _geometry(n=3000, n_layers=24, seed=1, dtype=np.float32)
    geom = {
        k: jnp.asarray(v) for k, v in pc.prepare_chain_geometry(
            e, dens, dist
        ).items()
    }
    theta = jnp.asarray(THETA, jnp.float32)
    if kind == "primal":
        return (lambda th, g: pc.osc_probs_planar(th, (1, -1), g)), (
            theta, geom), 1
    if kind == "tangent":
        def vg(th, g):
            return jax.value_and_grad(lambda t: jnp.sum(
                pc.osc_probs_planar(t, (1, -1), g, active=(1, 2, 5))
            ))(th)
        return vg, (theta, geom), 4
    if kind == "jacfwd":
        return (lambda th, g: jax.jacfwd(lambda t: jnp.sum(
            pc.osc_probs_planar(t, (1, -1), g, active=(1, 2, 5)),
            axis=(0, 1, 2),
        ))(th)), (theta, geom), 3
    thetas = jnp.tile(theta, (8, 1))
    return (lambda ths, g: jax.vmap(
        lambda t: pc.osc_probs_planar(t, (1, -1), g)
    )(ths)), (thetas, geom), 1


@pytest.mark.parametrize("kind", ["primal", "tangent", "jacfwd", "vmap"])
def test_lowers_for_cuda(kind):
    """The Triton-route kernels lower for CUDA at float32: the primal, the
    value-and-gradient (primal + 3 tangent launches), the forward-mode
    jacobian (3 tangent launches; the unused primal is dropped) and the
    vmapped primal (one batched launch)."""
    fn, args, n_calls = _lowering_case(kind)
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert text.count("__gpu$xla.gpu.triton") == n_calls


# -- path choice ------------------------------------------------------------
@pytest.mark.parametrize(
    "platform, dtype, standard, expected",
    [
        ("gpu", np.float32, True, True),
        ("cpu", np.float32, True, False),
        ("gpu", np.float64, True, False),
        ("gpu", np.float32, False, False),
    ],
)
def test_path_choice(platform, dtype, standard, expected):
    assert pc.use_chain_kernel(platform, dtype, standard) is expected


@pytest.mark.parametrize(
    "option",
    [{}, {"neutrino_decay": True}, {"nsi_type": "standard"},
     {"lri_type": "emu-symmetry"}, {"tomography_type": "mass_of_earth"},
     {"layer_dedup": True}],
)
def test_prob3_path_follows_physics(monkeypatch, option):
    """prob3 runs the kernel only for standard physics on a GPU in
    float32 (the platform and dtype are faked here)."""
    from pisa_tpu.stages.osc import prob3 as prob3_mod

    monkeypatch.setattr(prob3_mod, "target_platform", lambda: "gpu")
    monkeypatch.setattr(prob3_mod, "FTYPE", np.float32)
    settings = dict(
        neutrino_decay=False, nsi_type=None, lri_type=None,
        tomography_type=None, layer_dedup=False,
    )
    settings.update(option)
    stage = types.SimpleNamespace(**settings)
    assert prob3_mod.prob3._use_kernel(stage) is (not option)
    monkeypatch.setattr(prob3_mod, "target_platform", lambda: "cpu")
    assert prob3_mod.prob3._use_kernel(stage) is False


def test_target_platform_follows_default_device():
    assert pc.target_platform() == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert pc.target_platform() == "cpu"


# -- the flagship stage on the kernel path ------------------------------------
def _small_flagship():
    """The flagship pipeline at 1% of the events on a 20x20 calc grid."""
    from pisa_tpu.config.parser import parse_pipeline_config
    from pisa_tpu.core.pipeline import Pipeline

    cfg = parse_pipeline_config("settings/pipeline/IceCube_3y_neutrinos.cfg")
    cfg[("data", "csv_loader")]["fraction_events_to_keep"] = 0.01
    for key, settings in cfg.items():
        cm = settings.get("calc_mode") if isinstance(key, tuple) else None
        if hasattr(cm, "downsample") and "true_energy" in cm.names:
            settings["calc_mode"] = cm.downsample(10)
    return Pipeline(cfg).compile()


def _xla_reference(v):
    """Template maps, the Asimov data and the objective gradient at `v` on
    the XLA path (evaluated now: programs trace on first call)."""
    ct = _small_flagship()
    ref = {m.name: np.asarray(m.hist) for m in ct.get_outputs(v)}
    data = ct.get_outputs()
    _, vg = ct.build_objective(data, "mod_chi2")
    val, g = vg(v)
    return ref, data, float(val), np.asarray(g)


def _use_interpreted_kernel(monkeypatch):
    """Select the chain kernel in prob3 as on a GPU, run interpreted."""
    from pisa_tpu.stages.osc import prob3 as prob3_mod

    monkeypatch.setattr(prob3_mod, "use_chain_kernel", lambda *a: True)
    monkeypatch.setattr(
        prob3_mod, "osc_probs_planar",
        functools.partial(pc.osc_probs_planar, interpret=True),
    )


def _check_against(ct, v, ref, data, val_x, g_x):
    for m in ct.get_outputs(v):
        np.testing.assert_allclose(
            np.asarray(m.hist), ref[m.name], rtol=1e-10 if _F64 else 1e-4,
            atol=1e-12 if _F64 else 1e-6,
        )
    _, vg = ct.build_objective(data, "mod_chi2")
    val, g = vg(v)
    np.testing.assert_allclose(float(val), val_x, rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(g), g_x, rtol=1e-7, atol=1e-9 * np.abs(g_x).max()
    )


_V_OFFSET = 0.05


def test_flagship_template_on_kernel_path(monkeypatch):
    """The stacked flagship template and its value_and_grad through the
    kernel path (interpreted) equal the XLA path's."""
    ct0 = _small_flagship()
    v = np.clip(ct0.current_rescaled_values() + _V_OFFSET, 0.05, 0.95)
    ref = _xla_reference(v)
    _use_interpreted_kernel(monkeypatch)
    ct = _small_flagship()
    assert "osc_blk_e" in ct._trace_data.containers[0]
    _check_against(ct, v, *ref)


def test_flagship_sharded_template_on_kernel_path(monkeypatch):
    """A sharded template runs the kernel under shard_map over the mesh
    and matches the unsharded XLA-path template and gradient."""
    from pisa_tpu.parallel import default_mesh

    ct0 = _small_flagship()
    v = np.clip(ct0.current_rescaled_values() + _V_OFFSET, 0.05, 0.95)
    ref = _xla_reference(v)
    _use_interpreted_kernel(monkeypatch)
    ct = _small_flagship().shard(default_mesh())
    los, his = ct._current_bounds()
    text = ct._jitted.lower(
        jnp.asarray(v), jnp.asarray(los), jnp.asarray(his), ct._data_vals
    ).as_text()
    assert "sdy.manual_computation" in text or "shard_map" in text
    _check_against(ct, v, *ref)


def test_fisher_on_kernel_path(monkeypatch):
    """The Fisher matrix (``jax.jacfwd`` of the compiled template) runs
    through the kernel's forward-mode rule and equals the XLA path's."""
    from pisa_tpu.analysis.fisher import get_fisher_matrix

    ct_x = _small_flagship()
    v = np.clip(ct_x.current_rescaled_values() + _V_OFFSET, 0.05, 0.95)
    f_x = get_fisher_matrix(ct_x, rescaled_vec=v).matrix
    _use_interpreted_kernel(monkeypatch)
    ct = _small_flagship()
    assert "osc_blk_e" in ct._trace_data.containers[0]
    f_k = get_fisher_matrix(ct, rescaled_vec=v).matrix
    assert np.all(np.isfinite(f_k))
    np.testing.assert_allclose(
        f_k, f_x, rtol=1e-7 if _F64 else 1e-3,
        atol=(1e-9 if _F64 else 1e-4) * np.abs(f_x).max(),
    )


# -- on the card ------------------------------------------------------------
def _flagship_grid():
    """The flagship calc grid's Earth-layer chains (200 x 200, PREM-12)."""
    from pisa_tpu.core.pipeline import Pipeline

    p = Pipeline("settings/pipeline/IceCube_3y_neutrinos.cfg")
    stage = [s for s in p.stages if type(s).__name__ == "prob3"][0]
    c = stage.data.containers[0]
    c.representation = stage.calc_mode
    return tuple(
        np.asarray(c[k], np.float32)
        for k in ("true_energy", "densities", "distances")
    )


def _xla_fp64_on_cpu(fn):
    """Run the reference in float64 on the CPU backend (the suite runs
    with x64 enabled)."""
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jax.jit(fn)())


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    """Compiled for the card at flagship width: probabilities within 1e-4
    absolute of the XLA formulation in float64 (fp32 chain products of up
    to 24 layers; the XLA formulation's own fp32 error there is ~4e-5)."""
    e, dens, dist = _flagship_grid()
    geom = pc.prepare_chain_geometry(e, dens, dist)
    out = np.asarray(jax.jit(
        lambda t, g: pc.osc_probs_planar(t, (1, -1), g)
    )(jnp.asarray(THETA, jnp.float32), geom))
    ref = _xla_fp64_on_cpu(lambda: _xla_planar(
        jnp.asarray(THETA), (1, -1), *(x.astype(np.float64)
                                       for x in (e, dens, dist))
    ))
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.gpu
def test_compiled_tangents_match_xla(gpu):
    """Compiled tangent launches vs float64 reverse mode through the XLA
    formulation, per free component, relative 1e-3 (fp32 sums of 480k
    terms)."""
    e, dens, dist = _flagship_grid()
    geom = pc.prepare_chain_geometry(e, dens, dist)
    w = np.random.RandomState(0).uniform(-1, 1, (2, 2, 3, e.size))
    wj = jnp.asarray(w, jnp.float32)
    g_k = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        wj * pc.osc_probs_planar(t, (1, -1), geom, active=(1, 2, 5))
    )))(jnp.asarray(THETA, jnp.float32)))
    g_x = _xla_fp64_on_cpu(lambda: jax.grad(lambda t: jnp.sum(
        jnp.asarray(w) * _xla_planar(
            t, (1, -1), *(x.astype(np.float64) for x in (e, dens, dist))
        )
    ))(jnp.asarray(THETA)))
    np.testing.assert_allclose(g_k[[1, 2, 5]], g_x[[1, 2, 5]], rtol=1e-3)
    assert np.all(g_k[[0, 3, 4]] == 0.0)
