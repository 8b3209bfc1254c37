"""The port's native I/O library (is3d2_tpu_torch/io/fastio.py with
is3d2_tpu_torch/csrc/is3d2_io.cpp) against numpy and the JAX package.

Tolerances: the parser returns np.loadtxt's bits; the alias tables are the
JAX package's bits (its own build of the same C++), and the per-cell
species probabilities they imply match the rates to <= 1e-6 relative, as
do those of the numpy plain version; the block writer gives the bytes of
the %-formatting the port's op-1 writers used before it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import build_workdir  # noqa: E402

from is3d2_tpu.io import fastio as j_fastio  # noqa: E402

from is3d2_tpu_torch.io import fastio  # noqa: E402


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_fastio"),
                         include_baryon=True)


def test_library_builds_into_the_port_build_dir():
    lib = fastio.build()
    assert lib == fastio.library_path() and lib.exists()
    assert lib.parent == Path(__file__).resolve().parent.parent / \
        "build" / "is3d2_tpu_torch"
    assert fastio.get_lib() is fastio.get_lib()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastio, "SRC", bad)
    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        fastio.build()


@pytest.mark.parametrize("name", ["input/surface.dat",
                                  "tables/gauss/gla_roots_weights.txt",
                                  "tables/momentum/pT_table.dat"])
def test_load_table_fast_is_loadtxt(workdir, name):
    path = workdir / name
    ref = np.loadtxt(path, dtype=np.float64, ndmin=2,
                     skiprows=1 if name.endswith("weights.txt") else 0)
    if name.endswith("weights.txt"):
        # its first line has 2 columns: the parser refuses the ragged table
        with pytest.raises(ValueError, match="ragged"):
            fastio.load_table_fast(path)
        body = path.parent / "body.txt"
        body.write_text("".join(path.read_text().splitlines(True)[1:]))
        path = body
    out = fastio.load_table_fast(path)
    assert out.dtype == np.float64 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_load_table_fast_comments_and_errors(tmp_path):
    p = tmp_path / "t.dat"
    p.write_text("# header 1 2 3\n1.5 -2e-3 7 # trailing 9 9\n\n"
                 "4 5 6e10\n")
    np.testing.assert_array_equal(fastio.load_table_fast(p),
                                  np.loadtxt(p, ndmin=2))
    (tmp_path / "empty.dat").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no numeric rows"):
        fastio.load_table_fast(tmp_path / "empty.dat")
    with pytest.raises(OSError):
        fastio.load_table_fast(tmp_path / "missing.dat")


def _implied_probabilities(prob, alias):
    """P(s) = (prob[s] + sum_t (1 - prob[t]) [alias[t] == s]) / S per row."""
    C, S = prob.shape
    p = prob.astype(np.float64).copy()
    rows = np.repeat(np.arange(C), S)
    np.add.at(p, (rows, alias.reshape(-1)), 1.0 - prob.reshape(-1).astype(np.float64))
    return p / S


@pytest.mark.parametrize("S", [1, 3, 37, 371])
def test_alias_tables(S):
    rng = np.random.default_rng(S)
    C = 64
    rates = rng.lognormal(0.0, 2.0, (C, S)) * (rng.random((C, S)) > 0.2)
    rates[0] = 0.0                 # an empty (masked) cell
    rates[1, :] = 1.0              # a uniform cell
    prob, alias = fastio.build_alias_tables(rates)
    ref_p, ref_a = j_fastio.build_alias_tables(rates)
    assert prob.dtype == np.float32 and alias.dtype == np.int32
    np.testing.assert_array_equal(prob, ref_p)
    np.testing.assert_array_equal(alias, ref_a)

    target = rates / np.maximum(rates.sum(axis=1, keepdims=True), 1e-300)
    live = rates.sum(axis=1) > 0
    for pr, al in ((prob, alias), fastio._build_alias_numpy(rates)):
        implied = _implied_probabilities(pr, al)
        assert np.abs(implied[live] - target[live]).max() <= 1e-6
        np.testing.assert_allclose(implied[~live], 1.0 / S)


def test_alias_builder_refuses_too_many_species():
    with pytest.raises(ValueError, match="32767"):
        fastio.build_alias_tables(np.ones((2, 40000)))


def _percent_blocks(cols, block, blank_tail, header):
    """The op-1 writers' former formatter: %.8e rows, tab separated, one
    blank line after each block."""
    data = np.column_stack(cols)
    n_blocks = data.shape[0] // block
    fmt = ("\t".join(["%.8e"] * data.shape[1]) + "\n") * block
    parts = [header + "\n"] if header else []
    for k in range(n_blocks):
        parts.append(fmt % tuple(data[k * block:(k + 1) * block].ravel()))
        if blank_tail or k < n_blocks - 1:
            parts.append("\n")
    return "".join(parts)


@pytest.mark.parametrize("blank_tail,header", [(1, "y\tphip\tpT\tv"), (0, "")])
def test_write_blocks_fast_is_percent_formatting(tmp_path, blank_tail, header):
    rng = np.random.default_rng(5)
    rows, block = 48, 16
    cols = [rng.lognormal(-5.0, 6.0, 2 * rows) * rng.choice([-1, 1], 2 * rows)
            for _ in range(3)]
    cols[0][:5] = [0.0, -0.0, 1e-310, 9.999999995e-3, 1.0]
    n = fastio.write_blocks_fast(str(tmp_path / "f_%lld.dat"), [7, -3],
                                 header, "\t", 8,
                                 np.array([0, rows, 2 * rows]), cols,
                                 blank_every=block, blank_tail=blank_tail)
    assert n == 2 * rows
    for i, fid in enumerate((7, -3)):
        ref = _percent_blocks([c[i * rows:(i + 1) * rows] for c in cols],
                              block, blank_tail, header)
        assert (tmp_path / f"f_{fid}.dat").read_text() == ref


def test_write_events_fast_rows(tmp_path):
    rng = np.random.default_rng(9)
    offsets = np.array([0, 3, 3, 7])
    mcid = rng.choice([211, -321, 2212], 7)
    cols = [rng.normal(size=7).astype(np.float32) for _ in range(2)]
    n = fastio.write_events_fast(str(tmp_path / "e_%lld.dat"), "n pid a b",
                                 " ", 9, True, offsets, mcid, cols,
                                 event_base=10)
    assert n == 7
    for e in range(3):
        lines = (tmp_path / f"e_{11 + e}.dat").read_text().splitlines()
        assert lines[0] == "n pid a b"
        rows = range(offsets[e], offsets[e + 1])
        assert lines[1:] == [f"{k} {mcid[r]} {float(cols[0][r]):.9e} "
                             f"{float(cols[1][r]):.9e}"
                             for k, r in enumerate(rows)]
