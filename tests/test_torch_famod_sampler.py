"""The port's df-5 (famod) sampler against the JAX package and against its
own op-1 df-5 spectra.

On the sampler workdir (tests/torch_parity.py: 60 cells, pi+ K+ p, 32 pT x
48 phi) with an EOS-consistent surface:
  * prepare_sampler_famod's rates (n_a = g Lambda^3 detA I_100), rescale
    matrix B and LRF columns against the JAX package's, f64: <= 1e-12 of
    each column's scale, equal breakdown masks; the yield estimate <= 1e-12;
  * statistical (torch's generator is not jax.random): the port's and the
    JAX sampler's dN/dy and pT histograms agree by a two-sample chi^2 at
    p > 1e-3; the sampled dN/dy closes on the port's op-1 df-5 f64 spectra
    on tables that resolve it (48 eta nodes, pT to 6 GeV) within 5 sigma +
    1% (tests/test_sampler_famod.py's bar is 2%); one seed
    repeats its bits and the kept yield is within 0.05 Ntot +
    5 sqrt(Ntot / n_events) of the estimate.
"""

import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (build_sampler_workdir, chi2_p,  # noqa: E402
                          port_config, sampler_inputs, scale_err)

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core import sampler as js  # noqa: E402
from is3d2_tpu.core.sampler_famod import \
    prepare_sampler_famod as j_prepare_sampler_famod  # noqa: E402
from is3d2_tpu.core.sampler_hist import \
    bin_sampled_particles as j_bin  # noqa: E402

from is3d2_tpu_torch.core import sampler as ps  # noqa: E402
from is3d2_tpu_torch.core.sampler_famod import \
    prepare_sampler_famod  # noqa: E402
from is3d2_tpu_torch.core.sampler_hist import bin_sampled_particles  # noqa: E402
from is3d2_tpu_torch.core.spectra import compute_spectra  # noqa: E402
from is3d2_tpu_torch.core.spectra_famod import Reconstruction  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import \
    write_quadrature_tables  # noqa: E402

torch.set_num_threads(2)

PIKP_N = 3
SETUP_COLUMNS = ("dst", "dsx", "dsy", "dsz", "ds_max", "T_mod", "alphaB_mod")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """An EOS-consistent surface, so that the VAH solver can reconstruct
    every cell (shear 0.03, bulk 0.01 of E + P)."""
    return build_sampler_workdir(tmp_path_factory.mktemp("torch_famod_s"),
                                 eos_consistent=True)


def jcfg(**kw):
    return JConfig(operation=2, df_mode=5, hrg_eos=3, include_shear_deltaf=1,
                   include_bulk_deltaf=1, cell_block=64, **kw)


def test_prepare_sampler_famod_matches_jax(workdir):
    cfg = jcfg(fast=1, compute_dtype="f64")
    ji = sampler_inputs(workdir, 5, jax_side=True)
    pi = sampler_inputs(workdir, 5, jax_side=False)
    jset, _ = j_prepare_sampler_famod(ji.surf, ji.species, ji.chosen, cfg)
    stats = Reconstruction()
    pset, species = prepare_sampler_famod(pi.surf, pi.species, pi.chosen,
                                          port_config(cfg), "cpu", stats)
    ref = np.asarray(jset.rates)
    assert pset.rates.dtype == torch.float64 and ref.max() > 0
    assert scale_err(pset.rates, ref) <= 1e-12
    pos = ref > 1e-6 * ref.max()
    assert np.max(np.abs(pset.rates.numpy()[pos] - ref[pos]) / ref[pos]) \
        <= 1e-12
    for f in SETUP_COLUMNS:
        assert scale_err(getattr(pset, f), getattr(jset, f)) <= 1e-12, f
    np.testing.assert_array_equal(pset.breaks_down.numpy(),
                                  np.asarray(jset.breaks_down))
    assert set(ps._DF_COLS_USED[5]) == set(jset.df_cols)
    for name in ps._DF_COLS_USED[5]:
        assert scale_err(pset.df_cols[name], jset.df_cols[name]) <= 1e-12, name
    assert stats.newton_iterations > 1
    assert species.mass.shape == (PIKP_N,)


def test_total_yield_df5_matches_jax(workdir):
    cfg = jcfg(min_num_hadrons=1e5)
    ji = sampler_inputs(workdir, 5, jax_side=True)
    pi = sampler_inputs(workdir, 5, jax_side=False)
    ref = js.compute_total_yield(ji.surf, ji.species, ji.chosen, ji.df_data,
                                 cfg, ji.laguerre)
    ours = ps.compute_total_yield(pi.surf, pi.species, pi.chosen, pi.df_data,
                                  port_config(cfg), pi.laguerre, "cpu")
    assert abs(ours - ref) <= 1e-12 * abs(ref) and ref > 0
    assert ps.number_of_events(ours, port_config(cfg)) == \
        js.number_of_events(ref, cfg)


def _sample(inp, cfg, n_events, seed):
    return ps.sample_particles(inp.surf, inp.species, inp.chosen, inp.df_data,
                               cfg, inp.laguerre, n_events, "cpu", seed=seed)


@pytest.fixture(scope="module")
def workdir_fine(workdir, tmp_path_factory):
    """The same surface with op-1 tables that resolve dN/dy: 48 eta nodes
    and pT up to 6 GeV (24 nodes leave heavy species ~1-2 % low and the
    3 GeV table misses a few percent of the protons, which the sampler
    draws)."""
    wd = shutil.copytree(workdir, tmp_path_factory.mktemp("famod_fine") / "wd")
    write_quadrature_tables(wd, 32, 48, 48, pT_max=6.0)
    return wd


def test_famod_sampler_closure_vs_smooth(workdir_fine):
    """tests/test_sampler_famod.py on the port: the sampled dN/dy against
    the op-1 df-5 f64 spectra (outflow on in both: the sampler's flux
    keep is its Theta(p.dsigma)), within 5 sigma + 1% (the JAX test's bar
    is 2%)."""
    inp = sampler_inputs(workdir_fine, 5, jax_side=False)
    cfg = port_config(jcfg(outflow=1, fast=1, pT_bins=30))
    smooth = compute_spectra(inp.surf, inp.species, inp.chosen, inp.grids,
                             inp.df_data, dataclasses.replace(
                                 cfg, operation=1, compute_dtype="f64"),
                             "cpu", laguerre=inp.laguerre)
    g = inp.grids
    w = g.pT_weight[None, :, None, None] * g.phi_weight[None, None, :, None]
    dN_dy_smooth = (w * smooth).sum(axis=(1, 2, 3))

    n_events = 20000
    out = _sample(inp, cfg, n_events, seed=21)
    hist = bin_sampled_particles(out, PIKP_N, cfg, n_events)
    counts = hist.dN_dy.sum(axis=1)
    dN_dy = counts / (2.0 * cfg.y_cut * n_events)
    sigma = np.sqrt(np.maximum(counts, 1.0)) / (2.0 * cfg.y_cut * n_events)
    assert g.pT.max() > 5.0 and g.eta.shape[0] == 48
    for i in range(PIKP_N):
        assert counts[i] > 2000
        assert abs(dN_dy[i] - dN_dy_smooth[i]) < 5.0 * sigma[i] \
            + 0.01 * dN_dy_smooth[i], (i, dN_dy[i], dN_dy_smooth[i])


def test_famod_sampler_deterministic_and_yield(workdir):
    inp = sampler_inputs(workdir, 5, jax_side=False)
    cfg = port_config(jcfg(fast=1, min_num_hadrons=2e5))
    Ntot = ps.compute_total_yield(inp.surf, inp.species, inp.chosen,
                                  inp.df_data, cfg, inp.laguerre, "cpu")
    n = ps.number_of_events(Ntot, cfg)
    a = _sample(inp, cfg, n, seed=5)
    b = _sample(inp, cfg, n, seed=5)
    for k in ("px", "py", "pz", "E", "sp_idx", "cell_idx", "event"):
        assert torch.equal(a[k], b[k]), k
    per_event = a["kept"] / n
    assert abs(per_event - Ntot) < 0.05 * Ntot + 5.0 * np.sqrt(Ntot / n)
    assert a["dropped"] == 0


def test_port_and_jax_famod_samplers_agree(workdir):
    n_events = 4000
    cfg = jcfg(outflow=1, fast=1, pT_bins=30, y_bins=20)
    ji = sampler_inputs(workdir, 5, jax_side=True)
    jout = js.sample_particles(ji.surf, ji.species, ji.chosen, ji.df_data,
                               cfg, ji.laguerre, n_events=n_events, seed=13)
    ref = j_bin(jout, PIKP_N, cfg, n_events)
    inp = sampler_inputs(workdir, 5, jax_side=False)
    out = _sample(inp, port_config(cfg), n_events, seed=13)
    ours = bin_sampled_particles(out, PIKP_N, port_config(cfg), n_events)
    for name in ("dN_dy", "dN_2pipTdpTdy"):
        for i in range(PIKP_N):
            p, chi2, dof = chi2_p(getattr(ours, name)[i],
                                   np.asarray(getattr(ref, name))[i])
            assert p > 1e-3, (name, i, chi2, dof)
