"""The whole op-1 slice: both CLIs on one synthetic workdir.

The JAX driver runs in process (CPU backend under the repo's conftest) and
the port's CLI on the CPU, on copies of the same workdir.  All five op-1
result files per species must agree: spectra-valued columns within the
case's bar relative on bins >= 1e-4 of the file's peak, and v_n within the
bar absolute (v_n is a ratio normalised to v_0 = 1, so its harmonics carry
no scale of their own).  Bars: 1e-6 for df 1/2 in f32c; 3e-5 for df 1/2
with use_pallas = 1 in f64 (the port's kernel B2 against the JAX
``_kernel`` in interpret mode, whose bf16-split dots put it further from
the f64 engine than plain f32); for df 3/4, 1e-4 in f32 and, on the
driver's in-memory spectra, 1e-10 in f64 (the files carry 9 significant
digits).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (CHOSEN, FEQMOD_BULK, FEQMOD_SHEAR,  # noqa: E402
                          build_workdir, max_rel_err)

from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402

from is3d2_tpu_torch import cli  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KINDS = ("dN_pTdpTdphidy", "vn", "dN_2pipTdpTdy", "dN_dphidy", "dN_dy")


def _load(path: Path) -> np.ndarray:
    skip = 1 if path.name.startswith("dN_pTdpTdphidy") else 0
    return np.loadtxt(path, skiprows=skip, ndmin=2)


def _compare_result_files(jax_wd: Path, port_wd: Path, tol: float) -> None:
    for kind in KINDS:
        for mcid in CHOSEN:
            name = f"{kind}_{mcid}.dat"
            ref = _load(jax_wd / "results/continuous" / name)
            out = _load(port_wd / "results/continuous" / name)
            assert out.shape == ref.shape, name
            n_key = 2 if kind != "dN_dy" else 1
            np.testing.assert_array_equal(out[:, :n_key], ref[:, :n_key])
            if kind == "vn":
                assert np.abs(out[:, 2:] - ref[:, 2:]).max() <= tol, name
                continue
            v, r = out[:, -1], ref[:, -1]
            assert np.isfinite(v).all() and (v >= 0).all(), name
            sig = np.abs(r) >= 1e-4 * np.abs(r).max()
            err = (np.abs(v - r)[sig] / np.abs(r)[sig]).max()
            assert err <= tol, f"{name}: {err:.3e}"
    avg = "tables/thermodynamic/average_thermodynamic_quantities.dat"
    assert (jax_wd / avg).read_bytes() == (port_wd / avg).read_bytes()


@pytest.mark.parametrize("df_mode", [1, 2])
def test_port_cli_matches_jax_driver(tmp_path, df_mode):
    wd = build_workdir(tmp_path / "jax", params={"df_mode": df_mode,
                                                 "compute_dtype": "f32c"})
    shutil.copytree(wd, tmp_path / "port")
    JIS3D(wd).run_particlization()
    assert cli.main([str(tmp_path / "port"), "--device", "cpu"]) == 0
    _compare_result_files(wd, tmp_path / "port", 1e-6)


@pytest.mark.parametrize("df_mode", [1, 2])
def test_port_cli_matches_jax_driver_use_pallas(tmp_path, df_mode):
    """use_pallas = 1 with the default compute_dtype f64: the JAX driver
    runs ``_kernel`` (interpret mode on the CPU backend), the port kernel
    B2's plain version."""
    wd = build_workdir(tmp_path / "jax", params={"df_mode": df_mode,
                                                 "compute_dtype": "f64",
                                                 "use_pallas": 1})
    shutil.copytree(wd, tmp_path / "port")
    JIS3D(wd).run_particlization()
    assert cli.main([str(tmp_path / "port"), "--device", "cpu"]) == 0
    _compare_result_files(wd, tmp_path / "port", 3e-5)


# eta tables of more nodes than one kernel launch takes (32, after the
# fold): one case per kernel route, at that route's bar
@pytest.mark.parametrize("params,n_eta,surface_kw,tol", [
    ({"df_mode": 1, "compute_dtype": "f32c", "eta_fold": 0}, 40, {}, 1e-6),
    ({"df_mode": 4, "compute_dtype": "f32"}, 66,
     {"shear_scale": 0.12, "bulk_scale": FEQMOD_BULK}, 1e-4),
    ({"df_mode": 2, "compute_dtype": "f64", "use_pallas": 1, "eta_fold": 0},
     80, {}, 3e-5),
], ids=["df1-f32c-40-unfolded", "df4-f32-66-folded-to-33",
        "df2-f64-use_pallas-80-unfolded"])
def test_port_cli_takes_any_eta_count(tmp_path, params, n_eta, surface_kw,
                                      tol):
    """Kernels B1, B3 and B2 on more eta nodes than one launch takes: the
    wrappers run the table chunk by chunk, and the result files agree with
    the JAX driver's, which takes any number of nodes."""
    wd = build_workdir(tmp_path / "jax", params=params, n_eta=n_eta,
                       **surface_kw)
    shutil.copytree(wd, tmp_path / "port")
    JIS3D(wd).run_particlization()
    assert cli.main([str(tmp_path / "port"), "--device", "cpu"]) == 0
    _compare_result_files(wd, tmp_path / "port", tol)


def test_port_f32_runs_kernel_b1_as_f32c(tmp_path):
    """compute_dtype f32 with the kernels on (use_pallas = -1) runs the
    compensated kernel B1, as the JAX package does on an accelerator: the
    result files are the bytes f32c writes."""
    runs = {}
    for dtype in ("f32", "f32c"):
        wd = build_workdir(tmp_path / dtype, params={"df_mode": 2,
                                                     "compute_dtype": dtype,
                                                     "use_pallas": -1})
        assert cli.main([str(wd), "--device", "cpu"]) == 0
        runs[dtype] = wd / "results/continuous"
    names = sorted(p.name for p in runs["f32c"].iterdir())
    assert len(names) == len(KINDS) * len(CHOSEN)
    for name in names:
        assert (runs["f32"] / name).read_bytes() == \
            (runs["f32c"] / name).read_bytes(), name


def _breakdown_line(out: str) -> str:
    lines = [ln for ln in out.splitlines() if "feqmod breaks down" in ln]
    assert len(lines) == 1, out
    return lines[0]


# f32 runs a milder surface than f64: the JAX f32 engine's own error
# reaches ~1e-4 on the large-viscosity one (ROADMAP C4)
@pytest.mark.parametrize("df_mode,dtype", [(3, "f32"), (4, "f32"),
                                           (3, "f64"), (4, "f64")])
def test_port_cli_matches_jax_driver_feqmod(tmp_path, capsys, df_mode, dtype):
    """df 3/4 through both CLIs on a surface where cells break down: the
    same breakdown line, and spectra within 1e-4 (f32: the port's kernel
    B3 against the JAX f32 fast path) or 1e-10 (f64: both f64 engines)."""
    shear = FEQMOD_SHEAR if dtype == "f64" else 0.12
    wd = build_workdir(tmp_path / "jax", params={"df_mode": df_mode,
                                                 "compute_dtype": dtype},
                       shear_scale=shear, bulk_scale=FEQMOD_BULK)
    port_wd = tmp_path / "port"
    shutil.copytree(wd, port_wd)
    ref = JIS3D(wd)
    ref.run_particlization()
    ref_line = _breakdown_line(capsys.readouterr().out)
    if dtype == "f32":
        assert cli.main([str(port_wd), "--device", "cpu"]) == 0
    else:
        run = IS3D(port_wd, device="cpu")   # what cli.main runs
        run.run_particlization()
        err = max_rel_err(run.spectra, np.asarray(ref.spectra))
        assert err <= 1e-10, f"in-memory spectra: {err:.3e}"
    line = _breakdown_line(capsys.readouterr().out)
    assert line == ref_line
    assert int(line.split()[4]) > 0
    _compare_result_files(wd, port_wd, 1e-4 if dtype == "f32" else 1e-7)


def test_port_takes_the_cpu_only_when_asked(tmp_path, monkeypatch):
    """Without a CUDA device the driver raises unless the CPU is named."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.driver import IS3D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(df_mode=1, compute_dtype="f32c")
    with pytest.raises(RuntimeError, match="--device cpu"):
        IS3D(tmp_path, cfg=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IS3D(tmp_path, cfg=cfg, device="cuda")
    assert IS3D(tmp_path, cfg=cfg, device="cpu").device == torch.device("cpu")


def test_port_runs_without_jax(tmp_path):
    """Full CPU runs of the slice in a fresh process -- df 2 through the
    f64 engine, df 1 with use_pallas = 1 through kernel B2's plain version,
    then df 4 through kernel B3's plain version -- never import jax or the
    JAX package, and give dN/dy in the physical order pi+ > K+ > p."""
    wd2 = build_workdir(tmp_path / "df2", params={"compute_dtype": "f64",
                                                  "df_mode": 2})
    wd1 = build_workdir(tmp_path / "df1_b2", params={"compute_dtype": "f64",
                                                     "df_mode": 1,
                                                     "use_pallas": 1})
    wd4 = build_workdir(tmp_path / "df4", params={"compute_dtype": "f32",
                                                  "df_mode": 4},
                        shear_scale=FEQMOD_SHEAR, bulk_scale=FEQMOD_BULK)
    code = (
        "import sys\n"
        "import is3d2_tpu_torch\n"
        "assert 'jax' not in sys.modules\n"
        "from is3d2_tpu_torch import cli\n"
        "from is3d2_tpu_torch.ops import cooper_frye_f32 as b2\n"
        "calls = []\n"
        "plain = b2.cooper_frye_f32_plain\n"
        "b2.cooper_frye_f32_plain = lambda *a: calls.append(1) or plain(*a)\n"
        f"cli.main([{str(wd2)!r}, '--device', 'cpu'])\n"
        f"cli.main([{str(wd1)!r}, '--device', 'cpu'])\n"
        "assert calls == [1], calls\n"
        f"cli.main([{str(wd4)!r}, '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'is3d2_tpu' or m.startswith('is3d2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "feqmod breaks down for" in proc.stdout
    for wd in (wd2, wd1, wd4):
        dndy = {m: float(np.loadtxt(wd / f"results/continuous/dN_dy_{m}.dat")[1])
                for m in (211, 321, 2212)}
        assert dndy[211] > dndy[321] > dndy[2212] > 0, wd.name
