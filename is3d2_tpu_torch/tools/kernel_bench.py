"""Time the kernels of this tree and of other trees on the card, inside one
call, and count what was compiled.

    python -m is3d2_tpu_torch.tools.kernel_bench [--tree NAME=DIR ...]
        [--only b1,b3,b2,prep] [--cells 100000] [--compare-cells 8192]
        [--f64-species 4] [--few-species 3,16] [--out build/kernel_bench.json]

The card's power limit may differ between calls, so two versions of a
kernel are only ever compared inside one run of this script.  ``--tree
NAME=DIR`` names a directory that holds another version of this package
(an earlier commit unpacked with ``git archive``, or a copy with an
experiment in it; under ``build/``, never committed).  Its wrappers are
imported under a name of their own and called on the same operands as this
tree's, so nothing here knows another tree's sources or C interfaces.  The
script

  * builds every tree's kernels (each tree's own ops/_build.py) and prints,
    from ``cuobjdump``, the registers, stack and shared memory of the
    instantiations the main paths launch, and their inner eta loops'
    instructions by pipe per evaluation (an evaluation is one MUFU.EX2 of
    the loop: every evaluation takes one expf);
  * makes the main paths' operands (df 1 f32c for B1; df 4 f32 with shear
    0.2 and bulk 0.1 for B3; df 2 f64 with use_pallas 1 for B2) at
    ``--cells`` cells with the full species list, times every tree there
    with CUDA events in the order trees, trees reversed, and holds each to
    this tree's plain version on the first ``--compare-cells`` cells;
  * B3: takes the ``--f64-species`` species on which the trees disagree
    most at that cut and holds every tree, and the plain version, to the
    f64 feqmod engine there, at the cut and at the full cell count;
  * every kernel of this tree: with the momenta cut to the first
    ``--few-species`` species (a chosen-particles list of a few hadrons:
    fewer blocks than the card holds), times the launch with the wrapper's
    cell split and with none;
  * ``prep`` (listed in ``--only``): the df-5 famod prep, whose VAH
    reconstruction is the df-5 path's first cost, of every tree on one
    EOS-consistent surface of ``--cells`` cells (kernel_check.famod_surface),
    twice after a warm-up, on the host clock with the device synchronised:
    its seconds, Newton iterations, cell blocks and cells iterated, and for
    the other trees the largest relative difference of (lambda, aT, aL) and
    the count of differing breakdown cells against this tree.

Needs a CUDA device, nvcc and cuobjdump; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import inspect
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..core.spectra_feqmod import spectra_feqmod
from ..io.pdg import read_pdg
from ..io.surface import read_surface
from ..ops.spectra_fast_common import comp_operands, f32_operands
from . import kernel_check as kc
from .synthetic import write_workdir

THIS_TREE = "this tree"

PIPES = {
    "fp32": r"^(FADD|FMUL|FFMA|FMNMX|FSEL|FSET|FSETP|FCHK)",
    "mufu": r"^MUFU",
    "convert": r"^(F2F|F2I|I2F|I2FP|F2FP|FRND)",
    "fp64": r"^(DADD|DMUL|DFMA|DSETP|DMNMX)",
    "shared load": r"^LDS",
    "global/const load": r"^(LDG|LDC|ULDC|LD\b)",
    "branch/call": r"^(BRA|CALL|RET|BSSY|BSYNC|EXIT|WARPSYNC|BREAK)",
}


# ----------------------------------------------------------------------
# what was compiled
# ----------------------------------------------------------------------

def _cuobjdump(*args: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, *args], capture_output=True, text=True,
                          check=True).stdout


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str, str]]]:
    """mangled kernel name -> [(address, opcode, operands)] from cuobjdump."""
    out: dict[str, list] = {}
    cur = None
    for line in _cuobjdump("-sass", str(lib)).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"\s*(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def resources(text: str) -> dict[str, dict[str, int]]:
    """mangled kernel name -> REG, STACK, SHARED, LOCAL from the text of
    ``cuobjdump -res-usage``."""
    return {name: {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL)"
                                                    r":(\d+)", line)}
            for name, line in re.findall(r"Function (\S+?):\s*\n\s*(REG:.*)",
                                         text)}


def inner_loops(code: list[tuple[int, str, str]]) -> list[dict]:
    """Instruction counts by pipe of every innermost loop (a backward branch
    with no other backward branch inside it) that holds a MUFU.EX2."""
    back = []
    for addr, op, args in code:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr:
            back.append((int(m.group(1), 16), addr))
    loops = []
    for lo, hi in back:
        if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in back):
            continue
        body = [(op, args) for addr, op, args in code if lo <= addr <= hi]
        n_exp = sum(op == "MUFU.EX2" for op, _ in body)
        if n_exp == 0:
            continue
        counts = {"instructions": len(body), "evaluations": n_exp}
        for pipe, pat in PIPES.items():
            counts[pipe] = sum(bool(re.match(pat, op)) for op, _ in body)
        counts["other"] = len(body) - sum(counts[p] for p in PIPES)
        counts["mufu kinds"] = sorted({op for op, _ in body
                                       if op.startswith("MUFU")})
        loops.append(counts)
    return loops


def report_build(label: str, name: str, lib: Path) -> dict:
    """Print and return the resources and eta loops of the instantiation the
    main path launches (of every kernel with an eta loop, where a tree names
    its kernels otherwise)."""
    code = sass_functions(lib)
    pat = kc.MAIN_PATH_KERNEL[name]
    names = [k for k in code if re.search(pat, k)] or list(code)
    usage = resources(_cuobjdump("-res-usage", str(lib)))
    record = {}
    for k in names:
        loops = inner_loops(code[k])
        if not loops:
            continue
        record[k] = {"resources": usage.get(k), "loops": loops}
        print(f"{label}: {usage.get(k)}  [{k[:70]}]")
        for lp in loops:
            n = lp["evaluations"]
            per = {key: round(v / n, 2) for key, v in lp.items()
                   if isinstance(v, int) and key != "evaluations"}
            print(f"{label}: eta loop of {n} evaluation(s); per evaluation "
                  f"{per}; {lp['mufu kinds']}")
    return record


# ----------------------------------------------------------------------
# trees and kernels
# ----------------------------------------------------------------------

def load_tree(index: int, directory: Path):
    """Import the package found in ``directory`` under a name of its own
    (its modules import each other relatively) and return it."""
    init = directory / "is3d2_tpu_torch" / "__init__.py"
    alias = f"is3d2_tpu_torch_tree{index}"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Kernel:
    """One kernel's main path: how to make its operands and call it."""

    key: str              # b1, b3, b2
    name: str             # module and source name
    params: dict          # iS3D parameters of the main path
    surface: dict         # make_surface options
    tol: float            # kernel vs plain version

    def wrapper(self, package_name: str):
        mod = importlib.import_module(f"{package_name}.ops.{self.name}")
        return getattr(mod, self.name)

    def library(self, package_name: str) -> Path:
        build = importlib.import_module(f"{package_name}.ops._build")
        return build.build(self.name)[0]


KERNELS = [
    Kernel("b1", "cooper_frye_comp", {"df_mode": 1, "compute_dtype": "f32c"},
           {}, kc.TOL),
    Kernel("b3", "cooper_frye_feqmod", {"df_mode": 4, "compute_dtype": "f32"},
           kc.FEQMOD_SURFACE, kc.FEQMOD_TOL_PLAIN),
    Kernel("b2", "cooper_frye_f32",
           {"df_mode": 2, "compute_dtype": "f64", "use_pallas": 1}, {},
           kc.F32_TOL_PLAIN),
]


def operands(kernel: Kernel, wd: Path):
    """(cfg, state, operands, args, cut, few): the main path's engine state
    and kernel arguments; ``cut(n)`` the arguments on the first n cells;
    ``few(s)`` on the first s species."""
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", 1, 2, False)
    if kernel.key == "b3":
        from ..ops import cooper_frye_feqmod as fk
        state = kc.feqmod_engine_state(wd, cfg, surf, "cuda")
        ops = fk.feqmod_operands(*state, cfg)

        def cut(n):
            return (ops.cols[:n].contiguous(), ops.mom,
                    ops.renorm[:n].contiguous(), ops.red[:n].contiguous(),
                    ops.eta, ops.n_per_species, cfg, ops.kind)

        def few(s):
            return (ops.cols, ops.mom[:, :s * ops.n_per_species].contiguous(),
                    ops.renorm[:, :s].contiguous(),
                    ops.red[:, :s].contiguous(), ops.eta, ops.n_per_species,
                    cfg, ops.kind)
        return cfg, state, ops, (*ops.args(), cfg, ops.kind), cut, few
    state = kc.engine_state(wd, cfg, surf, "cuda")
    if kernel.key == "b1":
        ops = comp_operands(*state, cfg)

        def cut(n):
            return (ops.cell[:n].contiguous(), ops.qm[:n].contiguous(),
                    ops.eta, ops.eta_w, ops.mom, cfg)

        def few(s):
            per = ops.mom.shape[1] // state[2].mass.shape[0]
            return (ops.cell, ops.qm, ops.eta, ops.eta_w,
                    ops.mom[:, :s * per].contiguous(), cfg)
        return cfg, state, ops, (*ops.args(), cfg), cut, few
    ops = f32_operands(*state, cfg)

    def cut(n):
        return (ops.cell[:n].contiguous(), ops.eta, ops.eta_w, ops.mom, cfg)

    def few(s):
        per = ops.mom.shape[1] // state[2].mass.shape[0]
        return (ops.cell, ops.eta, ops.eta_w,
                ops.mom[:, :s * per].contiguous(), cfg)
    return cfg, state, ops, (*ops.args(), cfg), cut, few


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def race(kernel: Kernel, versions: dict, args: tuple, cut: tuple, plain,
         state) -> tuple[dict, dict]:
    """Time every tree on ``args`` (twice, mirrored order) and hold it to
    ``plain`` on ``cut``.  Returns (record, each tree's spectra on the
    cut)."""
    ref = kc.spectra_units(state, plain(*cut))
    results, spectra = {}, {"plain version": ref}
    for label, call in versions.items():
        out = call(*cut)                    # builds are done; this warms up
        again = call(*cut)
        spectra[label] = kc.spectra_units(state, out)
        results[label] = {"ms": [],
                          "vs_plain": kc.max_rel_err(spectra[label], ref),
                          "repeats": bool(torch.equal(out, again)),
                          "finite": bool(np.isfinite(spectra[label]).all())}
    for label in list(versions) + list(reversed(versions)):
        results[label]["ms"].append(cuda_ms(lambda: versions[label](*args)))
    mine = min(results[THIS_TREE]["ms"])
    for label, r in results.items():
        note = ""
        if label == THIS_TREE:      # the plain version follows this tree only
            ok = r["finite"] and r["repeats"] and r["vs_plain"] <= kernel.tol
            note = "  ok" if ok else "  MISSES ITS BAR"
        print(f"{kernel.key} {label:20s} {r['ms'][0]:9.1f} {r['ms'][1]:9.1f} ms"
              f"  {min(r['ms']) / mine:.3f}x this tree's  vs this tree's plain"
              f" version {r['vs_plain']:.3e}  repeats {r['repeats']}{note}")
    return results, spectra


def disagreeing_species(spectra: dict, n: int) -> list[int]:
    """The ``n`` species on which the other trees differ most from this
    one (relative, on bins >= FLOOR of the species' peak)."""
    mine = spectra[THIS_TREE]
    peak = np.abs(mine).max(axis=1, keepdims=True)
    worst = np.zeros(mine.shape[0])
    for label, other in spectra.items():
        if label == THIS_TREE:
            continue
        rel = np.where(np.abs(mine) >= kc.FLOOR * peak,
                       np.abs(other - mine) / np.abs(mine), 0.0)
        worst = np.maximum(worst, rel.max(axis=1))
    return sorted(int(s) for s in np.argsort(worst)[::-1][:n])


def feqmod_f64(state, cfg: Config, n_cells: int, species: list[int]):
    """The f64 feqmod engine on the first ``n_cells`` cells and the given
    species: (len(species), NpT * Nphi) spectra on the host."""
    cells, fq, sp, grid = state
    cells = type(cells)(**{f.name: getattr(cells, f.name)[:n_cells]
                           for f in dataclasses.fields(cells)})
    fq = type(fq)(**{f.name: getattr(fq, f.name)[:n_cells]
                     for f in dataclasses.fields(fq)})
    fq = dataclasses.replace(fq, renorm=fq.renorm[:, species])
    sp = type(sp)(**{f.name: getattr(sp, f.name)[species]
                     for f in dataclasses.fields(sp)})
    out = spectra_feqmod(cells, fq, sp, grid, cfg)
    return out.reshape(len(species), -1).cpu().numpy()


def hold_to_f64(label: str, spectra: dict, ref: np.ndarray,
                species: list[int]) -> dict:
    record = {}
    for name, out in spectra.items():
        record[name] = kc.max_rel_err(out[species], ref)
        print(f"b3 {label}: {name:20s} vs the f64 engine "
              f"{record[name]:.3e}"
              + ("" if record[name] <= kc.FEQMOD_TOL_F64
                 else f"  above {kc.FEQMOD_TOL_F64:g}"))
    return record


def race_split(kernel: Kernel, few, n_species: int) -> dict:
    """This tree's launch on the first ``n_species`` species, with the
    wrapper's cell split and with none."""
    mod = importlib.import_module(f"..ops.{kernel.name}", __package__)
    wrapper = getattr(mod, kernel.name)
    args = few(n_species)
    # the momentum rows: argument 4 of B1, 3 of B2, 1 of B3
    n_mom = args[{"b1": 4, "b2": 3, "b3": 1}[kernel.key]].shape[1]
    out = wrapper(*args)
    g = wrapper.last_geometry
    grid = g.grid if kernel.key == "b3" else g
    one = dataclasses.replace(grid, n_split=1,
                              cells_per_split=args[0].shape[0])
    unsplit = dataclasses.replace(g, grid=one) if kernel.key == "b3" else one
    same = torch.equal(out, mod.launch(*args, g))
    ms = {"split": [], "no split": []}
    for which, geom in (("split", g), ("no split", unsplit),
                        ("no split", unsplit), ("split", g)):
        ms[which].append(cuda_ms(lambda: mod.launch(*args, geom)))
    print(f"{kernel.key} first {n_species} species ({n_mom} momenta, "
          f"{grid.blocks} blocks): split in {grid.n_split} "
          f"{ms['split'][0]:.1f} {ms['split'][1]:.1f} ms, no split "
          f"{ms['no split'][0]:.1f} {ms['no split'][1]:.1f} ms "
          f"({min(ms['no split']) / min(ms['split']):.2f}x); repeats {same}")
    return {"blocks": grid.blocks, "n_split": grid.n_split, **ms}


def race_prep(packages: dict, wd: Path, n_cells: int) -> dict:
    """Time every tree's prepare_famod on one famod surface (see the module
    docstring) and hold the others to this tree's result."""
    surf = kc.famod_surface(wd, n_cells, 3, "cuda")
    table = read_pdg(3, wd / "PDG")
    cfg = Config(df_mode=5, compute_dtype="f32")

    def prep(package):
        sf = importlib.import_module(f"{package}.core.spectra_famod")
        cells = sf.famod_cells(surf, cfg, "cuda")
        stats = sf.Reconstruction()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fm = sf.prepare_famod(cells, table, cfg, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, stats, fm

    prep(packages[THIS_TREE])                   # warm-up
    record, preps = {}, {}
    for label in list(packages) * 2:
        seconds, stats, preps[label] = prep(packages[label])
        r = record.setdefault(label, {"seconds": []})
        r["seconds"].append(seconds)
        r.update(newton_iterations=stats.newton_iterations,
                 blocks=stats.blocks, cell_iterations=stats.lane_iterations)
    ref = preps[THIS_TREE]
    for label, r in record.items():
        fm = preps[label]
        if label != THIS_TREE:
            r["max_rel_diff"] = max(
                float(((getattr(fm, k) - getattr(ref, k)).abs()
                       / getattr(ref, k).abs().clamp(min=1e-300)).max())
                for k in ("lam", "aT", "aL"))
            r["breakdown_cells_differing"] = int(
                (fm.breaks_down != ref.breaks_down).sum())
        print(f"prep {label:20s} {json.dumps(r)}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="another version of the package to time beside "
                         "this one (repeatable)")
    ap.add_argument("--only", default="b1,b3,b2")
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--compare-cells", type=int, default=8192)
    ap.add_argument("--f64-species", type=int, default=4)
    ap.add_argument("--few-species", default="3,16")
    ap.add_argument("--out", type=Path,
                    default=Path("build/kernel_bench.json"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("card:", card)
    packages = {THIS_TREE: __package__.rsplit(".", 1)[0]}
    for i, item in enumerate(a.tree):
        label, _, directory = item.partition("=")
        packages[label] = load_tree(i, Path(directory)).__name__
    kernels = [k for k in KERNELS if k.key in a.only.split(",")]
    few_species = [int(s) for s in a.few_species.split(",") if s]

    record = {"card": card, "cells": a.cells, "builds": {}, "kernels": {}}
    for k in kernels:
        for label, package in packages.items():
            record["builds"][f"{k.key} {label}"] = report_build(
                f"{k.key} [{label}]", k.name, k.library(package))

    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = Path("build")
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for k in kernels:
            wd = write_workdir(Path(tmp) / k.key, n_cells=a.cells,
                               params=k.params, **k.surface)
            cfg, state, ops, args, cut, few = operands(k, wd)
            print(f"{k.key}: {args[0].shape[0]} cells x {ops.eta.shape[0]} "
                  f"eta x {ops.mom.shape[1]} momenta")
            # as the main path calls them: with the phi count, where a
            # tree's wrapper takes it
            versions = {}
            for label, package in packages.items():
                call = k.wrapper(package)
                if "row_len" in inspect.signature(call).parameters:
                    call = functools.partial(call, row_len=ops.row_len)
                versions[label] = call
            mine = importlib.import_module(
                f"{packages[THIS_TREE]}.ops.{k.name}")
            plain = getattr(mine, f"{k.name}_plain")
            rec, spectra = race(k, versions, args, cut(a.compare_cells),
                                plain, state)
            print(f"{k.key}: geometry {getattr(mine, k.name).last_geometry}")
            if k.key == "b3" and a.f64_species:
                species = disagreeing_species(spectra, a.f64_species) \
                    if len(spectra) > 2 else list(range(a.f64_species))
                print(f"b3: species held to the f64 engine: {species}")
                rec["f64_species"] = species
                rec["vs_f64_cut"] = hold_to_f64(
                    f"first {a.compare_cells} cells", spectra,
                    feqmod_f64(state, cfg, a.compare_cells, species), species)
                full = {label: kc.spectra_units(state, call(*args))
                        for label, call in versions.items()}
                rec["vs_f64_full"] = hold_to_f64(
                    f"all {args[0].shape[0]} cells", full,
                    feqmod_f64(state, cfg, args[0].shape[0], species), species)
            rec["few_species"] = {s: race_split(k, few, s)
                                  for s in few_species}
            record["kernels"][k.name] = rec
            del ops, args, cut, few, state, versions
            torch.cuda.empty_cache()
        if "prep" in a.only.split(","):
            wd = write_workdir(Path(tmp) / "prep", n_cells=16)
            record["prep"] = race_prep(packages, wd, a.cells)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(record, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
