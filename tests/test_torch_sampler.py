"""The port's sampler (operation 2) against the JAX package and against its
own op-1 spectra.

Deterministic parity on the same inputs (the JAX package run on the CPU):
  * compute_particle_densities: <= 1e-12 relative per species;
  * the LRF boosts (boost_dsigma, boost_diffusion, boost_momentum_to_lab):
    <= 1e-13 of each column's scale;
  * prepare_sampler's columns and rates, df 1-4, fast 1 and 0 at f64:
    <= 1e-12 of each column's scale; fast 0 at f32: rates <= 1e-5
    relative;
  * compute_total_yield <= 1e-12 relative, number_of_events equal;
  * unpack_ids(pack_ids(...)) is the identity.

Statistical (torch's generator is not jax.random): the closures of the JAX
package's tests/test_sampler.py, run on the port against its own op-1 f64
spectra with regulation and outflow on (pi+, K+, p): dN/dy within
5 sigma + 1% (df 1-4), the pion pT shape within 5/sqrt(n) + 5%, dN/dphi
within 5 sigma + 3% with drawn/kept < 2.7 (df 1), the kept yield within
0.05 Ntot + 5 sqrt(Ntot / n_events) of the estimate; seeds repeat their
bits; chunked campaigns match one chunk; the lean host boost matches the
device boost to <= 1e-5; and one cross-package check (df 1 and 4): the
port's and the JAX sampler's dN/dy and pT histograms agree by a two-sample
chi^2 at p > 1e-3.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (build_sampler_workdir, chi2_p,  # noqa: E402
                          numpy_fields, port_config, sampler_inputs,
                          scale_err)

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core import sampler as js  # noqa: E402
from is3d2_tpu.core.cells import prepare_cells as j_prepare_cells  # noqa: E402
from is3d2_tpu.core.sampler_hist import \
    bin_sampled_particles as j_bin  # noqa: E402
from is3d2_tpu.physics import lrf as j_lrf  # noqa: E402

from is3d2_tpu_torch import interop  # noqa: E402
from is3d2_tpu_torch.core import sampler as ps  # noqa: E402
from is3d2_tpu_torch.core.sampler_hist import (ChunkBinner,  # noqa: E402
                                               bin_sampled_particles)
from is3d2_tpu_torch.core.spectra import compute_spectra  # noqa: E402
from is3d2_tpu_torch.physics import lrf  # noqa: E402

torch.set_num_threads(1)

PIKP_N = 3


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_sampler_workdir(tmp_path_factory.mktemp("torch_sampler"))


@pytest.fixture(scope="module")
def workdir_feqmod(tmp_path_factory):
    """Large viscous corrections: some cells' feqmod breaks down."""
    return build_sampler_workdir(tmp_path_factory.mktemp("torch_sampler_f"),
                                 shear_scale=0.2, bulk_scale=0.1)


@pytest.fixture(scope="module")
def workdir_baryon(tmp_path_factory):
    return build_sampler_workdir(tmp_path_factory.mktemp("torch_sampler_b"),
                                 include_baryon=True, n_muB=9)


def jcfg(df_mode, include_baryon=False, **kw):
    return JConfig(operation=2, df_mode=df_mode, hrg_eos=3,
                   include_baryon=int(include_baryon),
                   include_baryondiff_deltaf=int(include_baryon),
                   include_shear_deltaf=1, include_bulk_deltaf=1,
                   cell_block=64, **kw)


def closure_cfg(df_mode, **kw):
    return port_config(jcfg(df_mode, regulate_deltaf=1, outflow=1, fast=1,
                            y_cut=5.0, **kw))


# ----------------------------------------------------------------------
# deterministic parity
# ----------------------------------------------------------------------

@pytest.mark.parametrize("df_mode", [1, 2, 3, 4])
def test_particle_densities_match_jax(workdir, df_mode):
    ours = sampler_inputs(workdir, df_mode, jax_side=False).species
    ref = sampler_inputs(workdir, df_mode, jax_side=True).species
    for name in ("equilibrium_density", "bulk_density", "diff_density"):
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        assert a.shape == b.shape == (len(ref),)
        nz = b != 0
        assert (a[~nz] == 0).all(), name
        if nz.any():
            assert np.max(np.abs(a[nz] - b[nz]) / np.abs(b[nz])) <= 1e-12, name


def test_particle_densities_with_baryons(workdir_baryon):
    for df_mode in (1, 2):
        ours = sampler_inputs(workdir_baryon, df_mode, False, True).species
        ref = sampler_inputs(workdir_baryon, df_mode, True, True).species
        for name in ("equilibrium_density", "bulk_density", "diff_density"):
            b = np.asarray(getattr(ref, name))
            assert scale_err(getattr(ours, name), b) <= 1e-12, name
            assert np.abs(b).max() > 0, name


def test_lrf_boosts_match_jax(workdir_baryon):
    inp = sampler_inputs(workdir_baryon, 1, True, True)
    cfg = jcfg(1, include_baryon=True)
    jc = j_prepare_cells(inp.surf, cfg, block=64)
    c = interop.cells_from_numpy(numpy_fields(jc))
    jb = j_lrf.milne_basis(jc.tau, jc.ux, jc.uy, jc.un)
    b = lrf.milne_basis(c.tau, c.ux, c.uy, c.un)

    jds = j_lrf.boost_dsigma(jb, jc.tau, jc.ux, jc.uy, jc.un, jc.dat, jc.dax,
                             jc.day, jc.dan)
    ds = lrf.boost_dsigma(b, c.tau, c.ux, c.uy, c.un, c.dat, c.dax, c.day,
                          c.dan)
    for f in ("t", "x", "y", "z", "space", "magnitude"):
        assert scale_err(getattr(ds, f), getattr(jds, f)) <= 1e-13, f

    jV = j_lrf.boost_diffusion(jb, jc.tau, jc.Vt, jc.Vx, jc.Vy, jc.Vn)
    V = lrf.boost_diffusion(b, c.tau, c.Vt, c.Vx, c.Vy, c.Vn)
    assert np.abs(np.asarray(jV[0])).max() > 0   # (Vz is 0 in 2+1d)
    for a, r in zip(V, jV):
        assert scale_err(a, r) <= 1e-13

    rng = np.random.default_rng(4)
    n = c.tau.shape[0]
    px, py, pz = (rng.normal(0.0, 0.5, n) for _ in range(3))
    E = np.sqrt(0.14**2 + px**2 + py**2 + pz**2)
    jp = j_lrf.boost_momentum_to_lab(jb, jc.tau, jc.ux, jc.uy, jc.un,
                                     E, px, py, pz)
    t = [torch.from_numpy(a) for a in (E, px, py, pz)]
    p = lrf.boost_momentum_to_lab(b, c.tau, c.ux, c.uy, c.un, *t)
    for a, r in zip(p, jp):
        assert scale_err(a, r) <= 1e-13


SETUP_COLUMNS = ("dst", "dsx", "dsy", "dsz", "ds_max", "pixx", "pixy", "pixz",
                 "piyy", "piyz", "pizz", "Vx", "Vy", "Vz", "shear_mod",
                 "isotropic_scale", "diff_mod", "T_mod", "alphaB_mod")


def _prepare_both(workdir, df_mode, baryon=False, **kw):
    cfg = jcfg(df_mode, include_baryon=baryon, **kw)
    ji = sampler_inputs(workdir, df_mode, True, baryon)
    pi = sampler_inputs(workdir, df_mode, False, baryon)
    jset, _ = js.prepare_sampler(ji.surf, ji.species, ji.chosen, ji.df_data,
                                 cfg, ji.laguerre)
    pset, _ = ps.prepare_sampler(pi.surf, pi.species, pi.chosen, pi.df_data,
                                 port_config(cfg), pi.laguerre, "cpu")
    return jset, pset


@pytest.mark.parametrize("df_mode,fast,surface", [
    (1, 1, "mild"), (2, 1, "mild"), (3, 1, "mild"), (4, 1, "mild"),
    (1, 0, "mild"), (2, 0, "mild"), (3, 0, "mild"), (4, 0, "mild"),
    (2, 1, "baryon"), (3, 0, "baryon"), (3, 1, "feqmod"), (4, 0, "feqmod")])
def test_prepare_sampler_matches_jax_f64(request, df_mode, fast, surface):
    wd = request.getfixturevalue({"mild": "workdir", "baryon": "workdir_baryon",
                                  "feqmod": "workdir_feqmod"}[surface])
    jset, pset = _prepare_both(wd, df_mode, surface == "baryon", fast=fast,
                               compute_dtype="f64")
    ref = np.asarray(jset.rates)
    assert pset.rates.dtype == torch.float64 and ref.max() > 0
    assert scale_err(pset.rates, ref) <= 1e-12
    pos = ref > 1e-6 * ref.max()
    assert np.max(np.abs(pset.rates.numpy()[pos] - ref[pos]) / ref[pos]) <= 1e-12
    for f in SETUP_COLUMNS:
        assert scale_err(getattr(pset, f), getattr(jset, f)) <= 1e-12, f
    np.testing.assert_array_equal(pset.breaks_down.numpy(),
                                  np.asarray(jset.breaks_down))
    for name in ps._DF_COLS_USED[df_mode]:
        assert scale_err(pset.df_cols[name], jset.df_cols[name]) <= 1e-12, name
    if surface == "feqmod":
        assert pset.breaks_down.any()


@pytest.mark.parametrize("df_mode", [2, 3, 4])
def test_exact_rates_f32_match_jax(workdir, df_mode):
    jset, pset = _prepare_both(workdir, df_mode, fast=0, compute_dtype="f32")
    ref = np.asarray(jset.rates, dtype=np.float64)
    pos = ref > 0
    rel = np.abs(pset.rates.numpy()[pos] - ref[pos]) / ref[pos]
    assert rel.max() <= 1e-5
    assert (pset.rates.numpy()[~pos] == 0).all()


@pytest.mark.parametrize("df_mode", [1, 2, 3, 4])
def test_total_yield_and_event_count_match_jax(workdir, df_mode):
    cfg = jcfg(df_mode, min_num_hadrons=1.0e5)
    ji = sampler_inputs(workdir, df_mode, True)
    pi = sampler_inputs(workdir, df_mode, False)
    ref = js.compute_total_yield(ji.surf, ji.species, ji.chosen, ji.df_data,
                                 cfg, ji.laguerre)
    ours = ps.compute_total_yield(pi.surf, pi.species, pi.chosen, pi.df_data,
                                  port_config(cfg), pi.laguerre, "cpu")
    assert ref > 0 and abs(ours - ref) <= 1e-12 * ref
    # the JAX package's cached densities carried across give the same yield
    interop.copy_species_densities(ji.species, pi.species)
    again = ps.compute_total_yield(pi.surf, pi.species, pi.chosen,
                                   pi.df_data, port_config(cfg), pi.laguerre,
                                   "cpu")
    assert abs(again - ref) <= 1e-12 * ref
    for c in (cfg, dataclasses.replace(cfg, oversample=0),
              dataclasses.replace(cfg, max_num_samples=7.0)):
        assert ps.number_of_events(ours, port_config(c)) == \
            js.number_of_events(ref, c)


def test_pack_unpack_identity():
    rng = np.random.default_rng(1)
    for C, S, E in ((102_400, 371, 34), (60, 3, 30_000), (1 << 17, 512, 64)):
        bits = ps.pack_bits(C, S, E)
        assert bits is not None and sum(bits) <= 32
        n = 5000
        cell, sp, ev = (rng.integers(0, m, n) for m in (C, S, E))
        cell[:2], sp[:2], ev[:2] = [0, C - 1], [0, S - 1], [0, E - 1]
        packed = ps.pack_ids(torch.from_numpy(cell), torch.from_numpy(sp),
                             torch.from_numpy(ev), bits)
        assert packed.dtype == torch.int32
        c2, s2, e2 = ps.unpack_ids(packed.numpy(), bits, ev0=100)
        np.testing.assert_array_equal(c2, cell)
        np.testing.assert_array_equal(s2, sp)
        np.testing.assert_array_equal(e2, ev + 100)
        # the JAX package unpacks the same lane the same way
        jc, jsp, je = js.unpack_ids(packed.numpy().view(np.uint32), bits, 100)
        np.testing.assert_array_equal(jc, cell)
        np.testing.assert_array_equal(jsp, sp)
        np.testing.assert_array_equal(je, ev + 100)
    assert ps.pack_bits(1 << 20, 1 << 10, 1 << 10) is None


def test_envelope_tilt_matches_jax_on_its_setup(workdir):
    jset, pset = _prepare_both(workdir, 1, fast=1)
    d = {f.name: numpy_fields(getattr(jset, f.name))
         if f.name in ("cells",) else np.asarray(getattr(jset, f.name))
         for f in dataclasses.fields(jset) if f.name not in ("fq", "df_cols")}
    d.update(fq=None, df_cols={k: np.asarray(v)
                               for k, v in jset.df_cols.items()})
    setup = interop.sampler_setup_from_numpy(d)
    cfg = port_config(jcfg(1))
    tilt = ps.envelope_tilt_cells(setup, cfg)
    ref = np.asarray(js._envelope_tilt_cells(jset, jcfg(1)))
    np.testing.assert_allclose(tilt.numpy(), ref, rtol=2e-7, atol=0)
    assert 0.25 <= float(tilt.min()) and float(tilt.max()) <= 1.0
    assert ps.envelope_tilt_cells(setup, port_config(jcfg(4))) is None


# ----------------------------------------------------------------------
# statistical closures against the port's own op-1 spectra
# ----------------------------------------------------------------------

def _smooth(inp, cfg):
    cfg64 = dataclasses.replace(cfg, operation=1, compute_dtype="f64")
    return compute_spectra(inp.surf, inp.species, inp.chosen, inp.grids,
                           inp.df_data, cfg64, "cpu", laguerre=inp.laguerre)


def _sample(inp, cfg, n_events, seed, **kw):
    return ps.sample_particles(inp.surf, inp.species, inp.chosen, inp.df_data,
                               cfg, inp.laguerre, n_events, "cpu", seed=seed,
                               **kw)


@pytest.mark.parametrize("df_mode", [1, 2, 3, 4])
def test_sampler_closure_vs_smooth(workdir, df_mode):
    inp = sampler_inputs(workdir, df_mode, jax_side=False)
    cfg = closure_cfg(df_mode, pT_bins=30)
    smooth = _smooth(inp, cfg)
    g = inp.grids
    w = g.pT_weight[None, :, None, None] * g.phi_weight[None, None, :, None]
    dN_dy_smooth = (w * smooth).sum(axis=(1, 2, 3))

    n_events = 20000
    out = _sample(inp, cfg, n_events, seed=7)
    hist = bin_sampled_particles(out, PIKP_N, cfg, n_events)
    counts = hist.dN_dy.sum(axis=1)
    dN_dy = counts / (2.0 * cfg.y_cut * n_events)
    sigma = np.sqrt(np.maximum(counts, 1.0)) / (2.0 * cfg.y_cut * n_events)
    for i in range(PIKP_N):
        assert counts[i] > 3000
        assert abs(dN_dy[i] - dN_dy_smooth[i]) < 5.0 * sigma[i] \
            + 0.01 * dN_dy_smooth[i], (i, dN_dy[i], dN_dy_smooth[i])

    pT_w = (cfg.pT_max - cfg.pT_min) / cfg.pT_bins
    pT_mid = cfg.pT_min + pT_w * (np.arange(cfg.pT_bins) + 0.5)
    sampled = hist.dN_2pipTdpTdy[0] / (2 * np.pi * 2.0 * cfg.y_cut * pT_w
                                       * pT_mid * n_events)
    grid = (g.phi_weight[None, :] * smooth[0, :, :, 0]).sum(axis=1) / (2 * np.pi)
    ref = np.interp(pT_mid, g.pT, grid)
    cnt = hist.dN_2pipTdpTdy[0]
    sel = cnt > 400
    assert sel.sum() > 5
    rel = np.abs(sampled[sel] - ref[sel]) / ref[sel]
    assert (rel < 5.0 / np.sqrt(cnt[sel]) + 0.05).all(), rel.max()


def test_sampler_closure_azimuthal(workdir):
    inp = sampler_inputs(workdir, 1, jax_side=False)
    cfg = closure_cfg(1, phip_bins=16)
    smooth = _smooth(inp, cfg)
    g = inp.grids
    smooth_phi = (g.pT_weight[:, None] * smooth[0, :, :, 0]).sum(axis=0)

    n_events = 30000
    out = _sample(inp, cfg, n_events, seed=11)
    assert out["kept"] > 20000
    assert out["drawn"] / out["kept"] < 2.7
    hist = bin_sampled_particles(out, PIKP_N, cfg, n_events)
    counts = hist.dN_dphipdy[0]
    bw = 2.0 * np.pi / cfg.phip_bins
    mids = bw * (np.arange(cfg.phip_bins) + 0.5)
    sampled = counts / (2.0 * cfg.y_cut * bw * n_events)
    ref = np.interp(mids, g.phi, smooth_phi, period=2 * np.pi)
    sigma = np.sqrt(np.maximum(counts, 1.0)) / (2.0 * cfg.y_cut * bw * n_events)
    assert (smooth_phi.max() - smooth_phi.min()) > 0.02 * smooth_phi.mean()
    tol = 5.0 * sigma + 0.03 * ref
    assert (np.abs(sampled - ref) < tol).all(), (np.abs(sampled - ref) / tol).max()


def test_total_yield_matches_sampled(workdir):
    inp = sampler_inputs(workdir, 2, jax_side=False)
    cfg = port_config(jcfg(2, fast=1))
    Ntot = ps.compute_total_yield(inp.surf, inp.species, inp.chosen,
                                  inp.df_data, cfg, inp.laguerre, "cpu")
    n_events = 20000
    out = _sample(inp, cfg, n_events, seed=5)
    kept = out["kept"] / n_events
    assert abs(kept - Ntot) < 0.05 * Ntot + 5.0 * np.sqrt(Ntot / n_events)


def test_sampler_deterministic(workdir):
    inp = sampler_inputs(workdir, 1, jax_side=False)
    cfg = port_config(jcfg(1, fast=1))
    a = ps.to_particle_list(_sample(inp, cfg, 200, seed=11))
    b = ps.to_particle_list(_sample(inp, cfg, 200, seed=11))
    assert a.n_valid == b.n_valid > 0
    for f in ("event", "mcid", "px", "py", "pz", "E", "eta", "x", "t"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    c = ps.to_particle_list(_sample(inp, cfg, 200, seed=12))
    assert c.n_valid != a.n_valid or not np.array_equal(c.px, a.px)


def test_sampler_event_chunking(workdir):
    """A campaign split into ~8 chunks covers every event and matches the
    one-chunk campaign's yield statistically."""
    inp = sampler_inputs(workdir, 1, jax_side=False)
    n_events = 400
    base = port_config(jcfg(1, fast=1))
    big = _sample(inp, base, n_events, seed=5)
    assert big["chunks"] == 1
    cfg = dataclasses.replace(base,
                              sampler_chunk_hadrons=big["drawn"] / 8)
    out = _sample(inp, cfg, n_events, seed=5)
    assert out["chunks"] >= 8 and out["largest_chunk"] < big["drawn"] / 4
    ev = out["event"].numpy()
    assert out["event"].shape[0] == out["kept"]
    assert ev.min() == 0 and ev.max() == n_events - 1
    assert len(np.unique(ev)) > 0.9 * n_events
    a, b = big["kept"], out["kept"]
    assert abs(a - b) < 6.0 * np.sqrt(a + b)
    assert out["dropped"] == 0


def test_streaming_binner_matches_concatenated(workdir):
    inp = sampler_inputs(workdir, 1, jax_side=False)
    n_events = 300
    cfg = dataclasses.replace(port_config(jcfg(1, fast=1)),
                              sampler_chunk_hadrons=2000.0)
    out = _sample(inp, cfg, n_events, seed=9)
    ref = bin_sampled_particles(out, PIKP_N, cfg, n_events)
    binner = ChunkBinner(PIKP_N, cfg)
    diags = _sample(inp, cfg, n_events, seed=9, chunk_consumer=binner)
    hist = binner.result(n_events)
    assert diags["chunks"] > 2 and diags["kept"] == out["kept"]
    for f in ("dN_dy", "dN_deta", "dN_2pipTdpTdy", "pT_count", "dN_dphipdy",
              "dN_taudtaudy", "dN_2pirdrdy", "dN_dphisdy"):
        np.testing.assert_array_equal(getattr(hist, f), getattr(ref, f), f)
    # the f32 atan2 / cos / sin of torch's CPU kernels may take another
    # (vectorized or scalar) path for a row in a chunk than in the
    # concatenation: the v_n sums agree to f32 rounding
    for f in ("vn_real", "vn_imag"):
        np.testing.assert_allclose(getattr(hist, f), getattr(ref, f),
                                   rtol=0, atol=1e-5)


def test_lean_host_boost_matches_device_boost(workdir):
    inp = sampler_inputs(workdir, 1, jax_side=False)
    cfg = port_config(jcfg(1, fast=1))
    coll = ps.ChunkCollector()
    _sample(inp, cfg, 500, seed=21, chunk_consumer=coll, lean=True)
    lean = coll.particle_list()
    dev = ps.to_particle_list(_sample(inp, cfg, 500, seed=21))
    assert lean.n_valid == dev.n_valid > 500
    np.testing.assert_array_equal(lean.event, dev.event)
    np.testing.assert_array_equal(lean.mcid, dev.mcid)
    np.testing.assert_array_equal(lean.tau, dev.tau)
    for f in ("px", "py"):
        a, b = getattr(lean, f), getattr(dev, f)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f
    # the rapidity streams differ: eta agrees in distribution
    q = np.linspace(5, 95, 7)
    assert np.abs(np.percentile(lean.eta, q)
                  - np.percentile(dev.eta, q)).max() < 0.35


@pytest.mark.parametrize("df_mode", [1, 4])
def test_port_and_jax_samplers_agree(workdir, df_mode):
    n_events = 4000
    cfg = jcfg(df_mode, regulate_deltaf=1, outflow=1, fast=1, pT_bins=30,
               y_bins=20)
    ji = sampler_inputs(workdir, df_mode, jax_side=True)
    jout = js.sample_particles(ji.surf, ji.species, ji.chosen, ji.df_data,
                               cfg, ji.laguerre, n_events=n_events, seed=13)
    ref = j_bin(jout, PIKP_N, cfg, n_events)
    inp = sampler_inputs(workdir, df_mode, jax_side=False)
    out = _sample(inp, port_config(cfg), n_events, seed=13)
    ours = bin_sampled_particles(out, PIKP_N, port_config(cfg), n_events)
    for name in ("dN_dy", "dN_2pipTdpTdy"):
        for i in range(PIKP_N):
            p, chi2, dof = chi2_p(getattr(ours, name)[i],
                                   np.asarray(getattr(ref, name))[i])
            assert p > 1e-3, (name, i, chi2, dof)
