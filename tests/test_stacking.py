"""
Container-stacking parity: a compiled template traced over the stacked
(category-axis) container must reproduce the per-container trace exactly —
maps, errors, objective value and analytic gradient — and the stacking
primitives must honor padding for unequal category sizes.

See pisa_tpu/core/stacking.py; the motivation is the latency-bound
small-fusion tail of the per-container trace (12 near-identical
per-category op chains).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pisa_tpu import FTYPE
from pisa_tpu.config.parser import parse_pipeline_config
from pisa_tpu.core import translation
from pisa_tpu.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu.core.container import Container, ContainerSet
from pisa_tpu.core.pipeline import Pipeline
from pisa_tpu.core.stacking import StackingError, build_stacked_set
from pisa_tpu import ureg

FRACTION = 0.02

TOL = (
    dict(rtol=1e-11, atol=1e-13)
    if FTYPE == np.float64
    else dict(rtol=2e-5, atol=1e-7)
)


def _flagship_config():
    cfg = parse_pipeline_config("settings/pipeline/IceCube_3y_neutrinos.cfg")
    cfg[("data", "csv_loader")]["fraction_events_to_keep"] = FRACTION
    return cfg


@pytest.fixture(scope="module")
def compiled_pair():
    import os

    assert os.environ.get("PISA_TPU_STACK", "1") not in ("0", "off")
    ct_stacked = Pipeline(_flagship_config()).compile()
    assert ct_stacked._trace_data is not ct_stacked.pipeline.data, (
        "flagship template did not stack"
    )
    os.environ["PISA_TPU_STACK"] = "0"
    try:
        ct_ref = Pipeline(_flagship_config()).compile()
    finally:
        del os.environ["PISA_TPU_STACK"]
    assert ct_ref._trace_data is ct_ref.pipeline.data
    return ct_ref, ct_stacked


def test_flagship_stacked_template_matches(compiled_pair):
    ct_ref, ct_st = compiled_pair
    v = np.clip(ct_ref.current_rescaled_values() + 0.07, 0.05, 0.95)
    maps_ref = ct_ref.get_outputs(v)
    maps_st = ct_st.get_outputs(v)
    assert [m.name for m in maps_st] == [m.name for m in maps_ref]
    for m_ref, m_st in zip(maps_ref, maps_st):
        np.testing.assert_allclose(
            np.asarray(m_st.hist), np.asarray(m_ref.hist), **TOL
        )
        if m_ref.error_hist is not None:
            np.testing.assert_allclose(
                np.asarray(m_st.error_hist),
                np.asarray(m_ref.error_hist),
                **TOL,
            )
    total = sum(float(np.sum(m.hist)) for m in maps_st)
    assert np.isfinite(total) and total > 0


def test_flagship_stacked_gradient_matches(compiled_pair):
    ct_ref, ct_st = compiled_pair
    data = ct_ref.get_outputs()
    _, vg_ref = ct_ref.build_objective(data, "mod_chi2")
    _, vg_st = ct_st.build_objective(data, "mod_chi2")
    v = np.clip(ct_ref.current_rescaled_values() + 0.06, 0.05, 0.95)
    val_ref, g_ref = vg_ref(v)
    val_st, g_st = vg_st(v)
    if FTYPE == np.float64:
        np.testing.assert_allclose(float(val_st), float(val_ref), rtol=1e-10)
        np.testing.assert_allclose(
            np.asarray(g_st), np.asarray(g_ref), rtol=1e-7, atol=1e-12
        )
    else:
        np.testing.assert_allclose(float(val_st), float(val_ref), rtol=1e-4)
        g_ref_a = np.asarray(g_ref)
        scale = np.max(np.abs(g_ref_a))
        np.testing.assert_allclose(
            np.asarray(g_st) / scale, g_ref_a / scale, atol=1e-3
        )
    assert np.isfinite(np.asarray(g_st)).all()
    assert np.max(np.abs(np.asarray(g_st))) > 0


def test_flagship_stacked_scan_totals_match(compiled_pair):
    ct_ref, ct_st = compiled_pair
    rng = np.random.RandomState(7)
    vecs = rng.uniform(
        0.1, 0.9, size=(4, len(ct_ref.current_rescaled_values()))
    ).astype(np.asarray(FTYPE(0)).dtype)
    t_ref = np.asarray(ct_ref.scan_totals(vecs))
    t_st = np.asarray(ct_st.scan_totals(vecs))
    np.testing.assert_allclose(t_st, t_ref, **TOL)


# ---------------------------------------------------------------------------
# primitives with unequal category sizes (padding)
# ---------------------------------------------------------------------------


def _toy_binning():
    e = OneDimBinning(
        "x", bin_edges=np.linspace(0.0, 1.0, 5) * ureg.dimensionless
    )
    z = OneDimBinning(
        "y", bin_edges=np.linspace(-1.0, 1.0, 4) * ureg.dimensionless
    )
    return MultiDimBinning([e, z])


def _toy_set():
    rng = np.random.RandomState(3)
    cs = ContainerSet("toy")
    sizes = {"a": 7, "b": 12, "c": 4}
    for name, n in sizes.items():
        c = Container(name, representation="events")
        c["x"] = rng.uniform(-0.2, 1.2, n).astype(FTYPE)  # incl. OOR
        c["y"] = rng.uniform(-1.0, 1.0, n).astype(FTYPE)
        c["weights"] = rng.uniform(0.5, 2.0, n).astype(FTYPE)
        c.set_aux_data("nubar", 1 if name != "b" else -1)
        cs.add_container(c)
    return cs


def test_stacked_histogram_unequal_sizes():
    cs = _toy_set()
    binning = _toy_binning()
    stacked = build_stacked_set(cs, coord_keys=("x", "y"))
    sc = stacked.containers[0]
    assert sc.n_pad == 12

    w = jnp.asarray(sc["weights"])
    hist_st = np.asarray(sc.stacked_histogram(w, binning))
    for i, c in enumerate(cs.containers):
        ref = np.asarray(
            translation.histogram(
                [c["x"], c["y"]], c["weights"], binning, averaged=False
            )
        )
        np.testing.assert_allclose(hist_st[i], ref, rtol=1e-6, atol=1e-7)

    # matmul path (cached one-hot) agrees with the scatter path
    sc.cached_hist_matrix(binning)
    hist_mm = np.asarray(sc.stacked_histogram(w, binning))
    np.testing.assert_allclose(hist_mm, hist_st, rtol=1e-6, atol=1e-7)


def test_stacked_binned_to_array_rows():
    cs = _toy_set()
    binning = _toy_binning()
    stacked = build_stacked_set(cs, coord_keys=("x", "y"))
    sc = stacked.containers[0]

    # grouped binned values: one row per nubar sign
    rng = np.random.RandomState(5)
    vals = rng.uniform(0.0, 1.0, (2, binning.size)).astype(FTYPE)
    grp = (np.asarray(sc.cat_aux("nubar")) < 0).astype(np.int32)
    sc.representation = binning
    sc.set_stacked("probs", jnp.asarray(vals), rows=grp)
    sc.representation = "events"
    got = np.asarray(sc["probs"])  # auto-translate: batched gather
    assert got.shape == (3, sc.n_pad)
    for i, c in enumerate(cs.containers):
        ref = np.asarray(
            translation.lookup([c["x"], c["y"]], vals[grp[i]], binning)
        )
        n = np.shape(c["weights"])[0]
        np.testing.assert_allclose(got[i, :n], ref, rtol=1e-6, atol=1e-7)
        # padded slots must be zeroed
        np.testing.assert_array_equal(got[i, n:], 0.0)


def test_barr_factored_fields_match_direct():
    """The precomputable Barr modification fields (pisa_tpu/ops/flux/barr.py
    'factored forms') reproduce the direct evaluation."""
    from pisa_tpu.ops.flux import barr

    rng = np.random.RandomState(11)
    e = jnp.asarray(rng.uniform(1.0, 200.0, 300).astype(FTYPE))
    cz = jnp.asarray(rng.uniform(-1.0, 1.0, 300).astype(FTYPE))
    for sys_val in (-1.7, 0.0, 0.9):
        for nubar in (1, -1):
            for flav, field_fn in (
                (0, barr.nubar_mod_field),
                (1, barr.nubar_mod_field),
            ):
                direct = barr.mod_ratio_nubar(nubar, flav, e, cz, sys_val)
                fact = barr.mod_ratio_nubar_from_field(
                    nubar, field_fn(flav, e, cz), sys_val
                )
                np.testing.assert_allclose(
                    np.asarray(fact), np.asarray(direct), rtol=5e-6
                )
        for flav in (0, 1):
            direct = barr.mod_ratio_uphor(flav, e, cz, sys_val)
            fact = barr.mod_ratio_uphor_from_field(
                barr.uphor_mod_field(flav, e, cz), sys_val
            )
            np.testing.assert_allclose(
                np.asarray(fact), np.asarray(direct), rtol=5e-6, atol=1e-7
            )
    for delta in (-0.3, 0.12):
        direct = barr.spectral_index_scale(e, 24.09, delta)
        fact = barr.spectral_index_scale_from_log(jnp.log(e / 24.09), delta)
        np.testing.assert_allclose(
            np.asarray(fact), np.asarray(direct), rtol=5e-6
        )


def test_stacking_rejects_mixed_keys():
    cs = _toy_set()
    cs.containers[1]["extra"] = np.ones(12, dtype=FTYPE)
    with pytest.raises(StackingError):
        build_stacked_set(cs, coord_keys=("x", "y"))


# ---------------------------------------------------------------------------
# events-calc-mode stacking (VERDICT r3 item 2): example.cfg (per-event
# barr_simple flux + per-event prob3 apply) and the KDE pipeline must run as
# ONE stacked trace with template AND gradient parity
# ---------------------------------------------------------------------------

def _events_mode_pair(cfg_path):
    import os

    def build():
        if callable(cfg_path):
            return cfg_path().compile()
        return Pipeline(cfg_path).compile()

    ct_stacked = build()
    assert ct_stacked._trace_data is not ct_stacked.pipeline.data, (
        f"{cfg_path} did not stack"
    )
    os.environ["PISA_TPU_STACK"] = "0"
    try:
        ct_ref = build()
    finally:
        del os.environ["PISA_TPU_STACK"]
    return ct_ref, ct_stacked


@pytest.mark.parametrize(
    "cfg", [
        "settings/pipeline/example.cfg",
        "settings/pipeline/kde_example.cfg",
    ],
)
def test_events_mode_stacked_parity(cfg):
    ct_ref, ct_stacked = _events_mode_pair(cfg)
    v = np.clip(ct_ref.current_rescaled_values() + 0.05, 0.05, 0.95)
    ref = {m.name: np.asarray(m.hist) for m in ct_ref.get_outputs(v)}
    for m in ct_stacked.get_outputs(v):
        np.testing.assert_allclose(np.asarray(m.hist), ref[m.name], **TOL)

    data = ct_ref.get_outputs(v)
    _, vg_ref = ct_ref.build_objective(data, "mod_chi2")
    _, vg_st = ct_stacked.build_objective(data, "mod_chi2")
    v2 = np.clip(v + 0.03, 0.05, 0.95)
    val_ref, g_ref = vg_ref(v2)
    val_st, g_st = vg_st(v2)
    np.testing.assert_allclose(
        float(val_st), float(val_ref),
        rtol=1e-8 if FTYPE == np.float64 else 1e-4,
    )
    g_ref, g_st = np.asarray(g_ref), np.asarray(g_st)
    assert np.all(np.isfinite(g_st)), (
        "stacked gradient has non-finite entries (NaN-padding hygiene)"
    )
    scale = max(np.max(np.abs(g_ref)), 1e-30)
    np.testing.assert_allclose(
        g_st / scale, g_ref / scale,
        atol=1e-6 if FTYPE == np.float64 else 1e-3,
    )


def test_events_calc_osc_stacked_parity():
    """prob3 calc_mode=events — per-event oscillations, a first-class
    reference mode (reference ``prob3.py:452`` runs per container
    representation; the pisa_modes notebook's calc/apply matrix) — must
    stack into ONE trace with template and gradient parity (VERDICT r4
    next-item 9)."""
    from pisa_tpu.config.parser import parse_pipeline_config

    def build():
        cfg = parse_pipeline_config("settings/pipeline/example.cfg")
        cfg[("osc", "prob3")]["calc_mode"] = "events"
        cfg[("osc", "prob3")]["apply_mode"] = "events"
        return Pipeline(cfg)

    ct_ref, ct_stacked = _events_mode_pair(build)
    # the stacked trace must really be stacked AND per-event osc
    assert ct_stacked._trace_data.containers[0].is_stacked
    v = np.clip(ct_ref.current_rescaled_values() + 0.05, 0.05, 0.95)
    ref = {m.name: np.asarray(m.hist) for m in ct_ref.get_outputs(v)}
    for m in ct_stacked.get_outputs(v):
        np.testing.assert_allclose(np.asarray(m.hist), ref[m.name], **TOL)

    data = ct_ref.get_outputs(v)
    _, vg_ref = ct_ref.build_objective(data, "mod_chi2")
    _, vg_st = ct_stacked.build_objective(data, "mod_chi2")
    v2 = np.clip(v + 0.03, 0.05, 0.95)
    val_ref, g_ref = vg_ref(v2)
    val_st, g_st = vg_st(v2)
    np.testing.assert_allclose(
        float(val_st), float(val_ref),
        rtol=1e-8 if FTYPE == np.float64 else 1e-4,
    )
    g_ref, g_st = np.asarray(g_ref), np.asarray(g_st)
    assert np.all(np.isfinite(g_st)), (
        "stacked per-event-osc gradient has non-finite entries"
    )
    scale = max(np.max(np.abs(g_ref)), 1e-30)
    np.testing.assert_allclose(
        g_st / scale, g_ref / scale,
        atol=1e-6 if FTYPE == np.float64 else 1e-3,
    )
