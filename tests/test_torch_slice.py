"""The whole op-1 slice: both CLIs on one synthetic workdir.

The JAX driver runs in process (CPU backend under the repo's conftest) and
the port's CLI on the CPU, on copies of the same workdir.  All five op-1
result files per species must agree: spectra-valued columns within 1e-6
relative on bins >= 1e-4 of the file's peak, and v_n within 1e-6 absolute
(v_n is a ratio normalised to v_0 = 1, so its harmonics carry no scale of
their own).
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

from torch_parity import CHOSEN, build_workdir  # noqa: E402

from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402

from is3d2_tpu_torch import cli  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KINDS = ("dN_pTdpTdphidy", "vn", "dN_2pipTdpTdy", "dN_dphidy", "dN_dy")


def _load(path: Path) -> np.ndarray:
    skip = 1 if path.name.startswith("dN_pTdpTdphidy") else 0
    return np.loadtxt(path, skiprows=skip, ndmin=2)


@pytest.mark.parametrize("df_mode", [1, 2])
def test_port_cli_matches_jax_driver(tmp_path, df_mode):
    wd = build_workdir(tmp_path / "jax", params={"df_mode": df_mode,
                                                 "compute_dtype": "f32c"})
    shutil.copytree(wd, tmp_path / "port")
    JIS3D(wd).run_particlization()
    assert cli.main([str(tmp_path / "port"), "--device", "cpu"]) == 0

    for kind in KINDS:
        for mcid in CHOSEN:
            name = f"{kind}_{mcid}.dat"
            ref = _load(wd / "results/continuous" / name)
            out = _load(tmp_path / "port/results/continuous" / name)
            assert out.shape == ref.shape, name
            n_key = 2 if kind != "dN_dy" else 1
            np.testing.assert_array_equal(out[:, :n_key], ref[:, :n_key])
            if kind == "vn":
                assert np.abs(out[:, 2:] - ref[:, 2:]).max() <= 1e-6, name
                continue
            v, r = out[:, -1], ref[:, -1]
            assert np.isfinite(v).all() and (v >= 0).all(), name
            sig = np.abs(r) >= 1e-4 * np.abs(r).max()
            err = (np.abs(v - r)[sig] / np.abs(r)[sig]).max()
            assert err <= 1e-6, f"{name}: {err:.3e}"
    avg = "tables/thermodynamic/average_thermodynamic_quantities.dat"
    assert (wd / avg).read_bytes() == (tmp_path / "port" / avg).read_bytes()


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
    """A full CPU run of the slice in a fresh process never imports jax or
    the JAX package, and its f64 engine gives dN/dy in the physical order
    pi+ > K+ > p."""
    wd = build_workdir(tmp_path / "wd", params={"compute_dtype": "f64",
                                                "df_mode": 2})
    code = (
        "import sys\n"
        "import is3d2_tpu_torch\n"
        "assert 'jax' not in sys.modules\n"
        "from is3d2_tpu_torch import cli\n"
        f"cli.main([{str(wd)!r}, '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'is3d2_tpu' or m.startswith('is3d2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    dndy = {m: float(np.loadtxt(wd / f"results/continuous/dN_dy_{m}.dat")[1])
            for m in (211, 321, 2212)}
    assert dndy[211] > dndy[321] > dndy[2212] > 0
