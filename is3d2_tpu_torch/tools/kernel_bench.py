"""Time the kernels of this tree and of other trees on the card, inside one
call, and count what was compiled.

    python -m is3d2_tpu_torch.tools.kernel_bench [--tree NAME=DIR ...]
        [--only b1,b3,b2,b1_3d,b3_3d,p1,p1_3d,b1_cells,prep]
        [--tile3d PxYxTxB ...] [--tile3d-b3 PxYxTxB ...]
        [--tile3d-p1 PxYxTxB ...] [--tile-cells TxB ...] [--branches]
        [--cells 100000] [--compare-cells 8192] [--f64-species 4]
        [--few-species 3,16] [--out build/kernel_bench.json]

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
    the loop: every evaluation takes one expf; in P1's 3+1d mode, whose
    exponentials the register tile shares, one MUFU.RCP);
  * makes the main paths' operands (df 1 f32c for B1; df 4 f32 with shear
    0.2 and bulk 0.1 for B3; df 2 f64 with use_pallas 1 for B2; ``b1_3d``,
    listed in ``--only``: df 1 f32c on a 3+1d surface, 21 y, for B1's 3+1d
    mode) at ``--cells`` cells with the full species list, times every
    tree there with CUDA events in the order trees, trees reversed, and
    holds each to this tree's plain version on the first
    ``--compare-cells`` cells;
  * ``b1_3d`` and ``b3_3d`` (B3's 3+1d mode: df 4 f32 on a 3+1d surface,
    shear 0.2, bulk 0.1): every tree's result at full size must equal
    this tree's bit for bit at the same cell split (a 3+1d mode's tile
    moves no rounding; the script exits 1 where one does not);
    ``--tile3d PxYxTxB`` (repeatable) adds a copy of this tree whose B1
    3+1d mode launches a tile of P phi x Y y, T threads a block and B
    blocks an SM (``tile_tree``), ``--tile3d-b3`` one whose B3 3+1d clean
    kernel does, so tile shapes race in one call.  A tree from before B3's
    3+1d route was split by cell is held to this tree's mixed kernel on
    every cell (``launch_3d``);
  * ``--branches`` with ``b3_3d``: B3's 3+1d mixed kernel on every cell as
    packed, with every cell on its modified branch and with every cell on
    its linearised branch, and the split route beside them
    (``race_branches``): each branch's ms per 1e12 evaluations and its
    share of the packed run;
  * B3: takes the ``--f64-species`` species on which the trees disagree
    most at that cut and holds every tree, and the plain version, to the
    f64 feqmod engine there, at the cut and at the full cell count;
  * every kernel of this tree: with the momenta cut to the first
    ``--few-species`` species (a chosen-particles list of a few hadrons:
    fewer blocks than the card holds), times the launch with the wrapper's
    cell split and with none;
  * ``p1`` (listed in ``--only``): kernel P1 of every tree on the mode-5
    main path's operands (df 1 f32c, a mode-5 surface of ``--cells``
    cells), each tree packing them by its own route (the fold gate where
    the tree has one), timed in the order trees, trees reversed, and held
    to this tree's plain version on the first ``--compare-cells`` cells
    at the JAX package's polarization bars (Snorm, P; kernel_check);
  * ``p1_3d`` (listed in ``--only``): P1's 3+1d mode of every tree on the
    3+1d mode-5 main path's operands (df 1 f32c, a 3+1d mode-5 surface of
    ``--cells`` cells, 21 y), timed and held as ``p1`` (``race_p1_3d``),
    each tree's bits against this tree's printed; ``--tile3d-p1 PxYxTxB``
    (repeatable; TILES_3D_P1) adds a copy of this tree whose 3+1d mode
    launches that tile;
  * ``b1_cells`` (listed in ``--only``): B1's per-cell mode (operation 0)
    of every tree that has one on the df-1 f32c operands of a surface of
    ``--cells`` cells (every live cell, eta folded, as the op-0 route hands
    it), timed in the order trees, trees reversed, beside this tree's
    op-1 kernel on the same operands, each with its share of B1's bound
    and held to this tree's plain version on the first
    ``--compare-cells`` cells (per (cell, species) in units of the cell's
    sum of |terms|, kernel_check.cells_scale) and to this tree's result
    (``race_cells``);
    ``--tile-cells TxB`` (repeatable; TILES_CELLS) adds a copy of this
    tree whose per-cell mode launches T threads a block, B blocks an SM;
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
import concurrent.futures
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
from ..ops import _build
from ..ops.spectra_fast_common import (comp_operands, comp_operands_3d,
                                       f32_operands)
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


def _back_edges(code: list[tuple[int, str, str]]) -> list[tuple[int, int]]:
    """(target, address) of every backward branch: the loops."""
    back = []
    for addr, op, args in code:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr:
            back.append((int(m.group(1), 16), addr))
    return back


def _by_pipe(ops: list[str]) -> dict:
    counts = {"instructions": len(ops)}
    for pipe, pat in PIPES.items():
        counts[pipe] = sum(bool(re.match(pat, op)) for op in ops)
    counts["other"] = len(ops) - sum(counts[p] for p in PIPES)
    return counts


def inner_loops(code: list[tuple[int, str, str]],
                unit: str = "MUFU.EX2") -> list[dict]:
    """Instruction counts by pipe of every innermost loop (a backward branch
    with no other backward branch inside it) that holds a MUFU.EX2, and
    its address range.  Its evaluations are its ``unit`` instructions: one
    MUFU.EX2 an evaluation, or, where a kernel shares its exponentials
    across a register tile (P1's 3+1d mode), one MUFU.RCP."""
    back = _back_edges(code)
    loops = []
    for lo, hi in back:
        if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in back):
            continue
        body = [op for addr, op, _ in code if lo <= addr <= hi]
        n_eval = sum(op == unit for op in body)
        if "MUFU.EX2" not in body or n_eval == 0:
            continue
        counts = {"evaluations": n_eval, **_by_pipe(body)}
        counts["mufu kinds"] = sorted({op for op in body
                                       if op.startswith("MUFU")})
        counts["range"] = (lo, hi)
        loops.append(counts)
    return loops


def per_evaluation(loop: dict) -> dict:
    """An ``inner_loops`` record's instruction counts by pipe per
    evaluation."""
    n = loop["evaluations"]
    return {key: v / n for key, v in loop.items()
            if isinstance(v, int) and key != "evaluations"}


def loop_nest(code: list[tuple[int, str, str]]) -> dict:
    """The eta loop (the innermost loop with a MUFU.EX2) per evaluation and
    what the loop around it runs outside it (a per-cell step): instruction
    counts by pipe, with the MUFU and F2F (conversion) instructions of
    each."""
    eta = inner_loops(code)[0]
    lo, hi = eta["range"]
    outer = [(a, b) for a, b in _back_edges(code)
             if a <= lo and hi <= b and (a, b) != (lo, hi)]
    a, b = min(outer, key=lambda r: r[1] - r[0])
    step_ops = [op for addr, op, _ in code
                if a <= addr <= b and not lo <= addr <= hi]
    step = _by_pipe(step_ops)
    n = eta["evaluations"]
    return {"eta_loop_per_evaluation": {
                k: eta[k] / n for k in ("instructions", "fp32", "mufu",
                                        "convert")},
            "evaluations_per_eta_iteration": n,
            "cell_step": {k: step[k] for k in ("instructions", "fp32",
                                               "mufu", "convert", "fp64")},
            "f2f_per_cell_step": sum(op.startswith("F2F") for op in step_ops)}


def report_build(label: str, name: str, lib: Path,
                 unit: str = "MUFU.EX2") -> dict:
    """Print and return the resources and eta loops of the instantiation the
    main path launches (of every kernel with an eta loop, where a tree names
    its kernels otherwise); ``unit``: see inner_loops."""
    code = sass_functions(lib)
    pat = kc.MAIN_PATH_KERNEL[name]
    names = [k for k in code if re.search(pat, k)] or list(code)
    usage = resources(_cuobjdump("-res-usage", str(lib)))
    ptxas = (_build.resource_usage(lib) if lib.with_suffix(".ptxas").exists()
             else {})
    record = {}
    for k in names:
        loops = inner_loops(code[k], unit)
        if not loops:
            continue
        spills = {key: ptxas.get(k, {}).get(key)
                  for key in ("spill_stores", "spill_loads")}
        record[k] = {"resources": usage.get(k), "spills": spills,
                     "loops": loops}
        print(f"{label}: {usage.get(k)} {spills}  [{k[:70]}]")
        for lp in loops:
            per = {key: round(v, 2) for key, v in per_evaluation(lp).items()}
            print(f"{label}: innermost loop of {lp['evaluations']} "
                  f"evaluation(s); per evaluation {per}; {lp['mufu kinds']}")
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

    key: str              # b1, b3, b2, b1_3d
    name: str             # wrapper name (and module and source, but below)
    params: dict          # iS3D parameters of the main path
    surface: dict         # write_workdir options
    tol: float            # kernel vs plain version
    source: str = ""      # module and source name, where not ``name``
    launch: str = "launch"   # the module's launcher on a given geometry

    @property
    def module(self) -> str:
        return self.source or self.name

    def wrapper(self, package_name: str):
        mod = importlib.import_module(f"{package_name}.ops.{self.module}")
        return getattr(mod, self.name)

    def library(self, package_name: str) -> Path:
        build = importlib.import_module(f"{package_name}.ops._build")
        return build.build(self.module)[0]


KERNELS = [
    Kernel("b1", "cooper_frye_comp", {"df_mode": 1, "compute_dtype": "f32c"},
           {}, kc.TOL),
    Kernel("b3", "cooper_frye_feqmod", {"df_mode": 4, "compute_dtype": "f32"},
           kc.FEQMOD_SURFACE, kc.FEQMOD_TOL_PLAIN),
    Kernel("b2", "cooper_frye_f32",
           {"df_mode": 2, "compute_dtype": "f64", "use_pallas": 1}, {},
           kc.F32_TOL_PLAIN),
    Kernel("b1_3d", "cooper_frye_comp_3d",
           {"df_mode": 1, "compute_dtype": "f32c"}, {"dimension": 3}, kc.TOL,
           source="cooper_frye_comp", launch="launch_3d"),
    Kernel("b3_3d", "cooper_frye_feqmod_3d",
           {"df_mode": 4, "compute_dtype": "f32"},
           {"dimension": 3, **kc.FEQMOD_SURFACE}, kc.FEQMOD_TOL_PLAIN,
           source="cooper_frye_feqmod", launch="launch_3d"),
]
# the 3+1d modes, whose tile moves no rounding
MODES_3D = ("b1_3d", "b3_3d")

# B1's 3+1d mode's tile shapes raced for its redesign: phi x y momenta a
# thread, threads a block, blocks an SM (--tile3d)
TILES_3D = ("4x3x128x3", "4x3x256x2", "4x7x128x3", "4x7x128x2", "8x3x128x2")
# B3's 3+1d mode's (--tile3d-b3): the first eight raced for the one
# kernel it had, now its mixed kernel; 4x7x128x2, 4x7x128x3, 4x3x128x3,
# 4x3x256x2 and 8x3x128x2 raced for its clean kernel when each term reached
# the f64 sums on its own, the rest with the compensated runs
TILES_3D_B3 = ("4x3x128x3", "4x3x256x2", "4x3x128x2", "4x1x128x4",
               "2x3x128x4", "4x7x128x2", "2x7x128x3", "2x1x128x4",
               "4x7x128x3", "8x3x128x2", "4x3x128x4", "8x3x128x3",
               "6x7x128x2", "8x7x128x2", "4x7x64x6", "6x7x64x4",
               "8x7x64x4")
# P1's 3+1d mode's (--tile3d-p1): the first eight raced when a thread's f64
# sums (5 P Y of them) lived in shared memory beside the cell tile and its
# y rows, the rest with the exponential factored and the sums in the
# launch's rows of its result
TILES_3D_P1 = ("4x3x64x4", "4x3x128x2", "2x3x128x4", "4x2x128x3",
               "4x1x128x4", "2x2x256x2", "2x7x128x2", "2x3x256x2",
               "4x7x64x4", "8x3x64x4", "6x3x64x5", "3x7x64x5", "4x3x64x6",
               "4x6x64x4", "4x7x128x2", "8x3x128x2", "6x3x64x4",
               "4x3x128x3", "2x7x64x6")
# the instruction P1's 3+1d mode runs once an evaluation (its exponentials
# are shared across the register tile)
P1_3D_UNIT = "MUFU.RCP"
# the line that fixes a 3+1d tile: B1's 3+1d mode's in
# csrc/cooper_frye_comp.cu, B3's clean kernel's in csrc/cooper_frye_feqmod.cu
# (its mixed kernel's constants carry an m: kP3m, ...)
TILE_LINE_3D = (r"constexpr int kP3 = \d+, kY3 = \d+, kThreads3 = \d+, "
                r"kMinBlocks3 = \d+;")


def _tree_copy(dst: Path, source: str, pattern: str, line: str) -> Path:
    """A copy of this tree in ``dst`` whose csrc/``source``.cu has its one
    line matching ``pattern`` replaced by ``line``."""
    here = Path(__file__).resolve().parent.parent
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(here, dst / here.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dst / here.name / "csrc" / f"{source}.cu"
    text, n = re.subn(pattern, line, src.read_text())
    if n != 1:
        raise RuntimeError(f"{src}: no single line {pattern!r}")
    src.write_text(text)
    return dst


def tile_tree(spec: str, root: Path,
              source: str = "cooper_frye_comp") -> Path:
    """A copy of this tree under ``root`` whose 3+1d mode in ``source``
    (B3's: its clean kernel) launches the tile ``spec`` = "PxYxTxB" (see
    TILES_3D); returns the copy's directory."""
    p, y, t, b = (int(v) for v in spec.split("x"))
    return _tree_copy(root / f"tile3d_{source}_{spec}", source, TILE_LINE_3D,
                      f"constexpr int kP3 = {p}, kY3 = {y}, "
                      f"kThreads3 = {t}, kMinBlocks3 = {b};")


def operands(kernel: Kernel, wd: Path):
    """(cfg, state, operands, args, cut, few): the main path's engine state
    and kernel arguments; ``cut(n)`` the arguments on the first n cells;
    ``few(s)`` on the first s species."""
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", 1, cfg.dimension, False)
    if kernel.key == "b3_3d":
        from ..ops import cooper_frye_feqmod as fk
        state = kc.feqmod_engine_state(wd, cfg, surf, "cuda")
        ops = fk.feqmod_operands_3d(*state, cfg)

        def cut(n):     # the first n live cells, clean and touched
            return (*ops.first(n).args(), cfg, ops.kind)

        def few(s):
            return (ops.cols, ops.cold,
                    ops.mom[:, :s * ops.n_per_species].contiguous(), ops.y,
                    ops.renorm[:, :s].contiguous(),
                    ops.red[:, :s].contiguous(), ops.n_per_species, cfg,
                    ops.kind)
        return cfg, state, ops, (*ops.args(), cfg, ops.kind), cut, few
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
    if kernel.key == "b1_3d":
        ops = comp_operands_3d(*state, cfg)

        def cut(n):
            return ops.cell[:n].contiguous(), ops.mom, cfg

        def few(s):
            per = ops.mom.shape[1] // state[2].mass.shape[0]
            return ops.cell, ops.mom[:, :s * per].contiguous(), cfg
        return cfg, state, ops, (*ops.args(), cfg), cut, few
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


def _geometries(wrapper) -> tuple:
    """The geometries of a wrapper's latest launch: B3's 3+1d route has
    two (its mixed kernel's, then its clean kernel's; a tree from before
    the split, one), every other wrapper one."""
    clean = getattr(wrapper, "last_clean_geometry", None)
    return ((wrapper.last_geometry,) if clean is None
            else (wrapper.last_geometry, clean))


def _splits(geoms: tuple) -> tuple:
    return tuple((g.n_split, g.cells_per_split) for g in geoms)


def relaunch(mod, kernel: Kernel, args: tuple, geoms: tuple, splits: tuple):
    """This tree's launch of ``kernel`` on ``args`` with the geometries
    ``geoms`` of its latest launch, their cell splits replaced by
    ``splits``.  For B3's 3+1d route with one split (a tree from before
    the route was split by cell) that is the mixed kernel on every cell."""
    geoms = [dataclasses.replace(g, n_split=n, cells_per_split=c)
             for g, (n, c) in zip(geoms, splits)]
    if len(geoms) == 2:
        return mod.launch_3d_split(*args, geoms[1], geoms[0])
    return getattr(mod, kernel.launch)(*args, geoms[0])


def equal_bits(kernel: Kernel, versions: dict, packages: dict,
               args: tuple) -> dict:
    """Every tree's result on ``args`` against this tree's at the same cell
    split: where a tree split the cells otherwise, this tree launches again
    with that tree's split.  Returns, per other tree, its split and
    whether the bits are equal."""
    mod = importlib.import_module(f"..ops.{kernel.module}", __package__)
    mine = versions[THIS_TREE](*args)
    geoms = _geometries(getattr(mod, kernel.name))
    record = {}
    for label in versions:
        if label == THIS_TREE:
            continue
        out = versions[label](*args)
        split = _splits(_geometries(kernel.wrapper(packages[label])))
        ref = mine if split == _splits(geoms) else \
            relaunch(mod, kernel, args, geoms[:len(split)], split)
        same = bool(torch.equal(out, ref))
        record[label] = {"split": split, "equal_bits": same}
        print(f"{kernel.key} {label:20s} vs this tree at full size, cell "
              f"split {split} (this tree's {_splits(geoms)}): equal bits "
              f"{same}")
        del out, ref
    return record


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


def race_split(kernel: Kernel, few, n_species: int, layout: dict) -> dict:
    """This tree's launch on the first ``n_species`` species, with the
    wrapper's cell split and with none; ``layout``: what the wrapper must
    be told of the grid (B1's 3+1d mode: its rapidity count)."""
    mod = importlib.import_module(f"..ops.{kernel.module}", __package__)
    wrapper = getattr(mod, kernel.name)
    launch = getattr(mod, kernel.launch)
    args = few(n_species)
    # the momentum rows: argument 4 of B1, 3 of B2, 1 of B3 and B1 3+1d,
    # 2 of B3 3+1d
    n_mom = args[{"b1": 4, "b2": 3, "b3": 1, "b1_3d": 1,
                  "b3_3d": 2}[kernel.key]].shape[1]
    out = wrapper(*args, **layout)
    g = wrapper.last_geometry
    grid = g.grid if kernel.key == "b3" else g
    one = dataclasses.replace(grid, n_split=1,
                              cells_per_split=args[0].shape[0])
    unsplit = dataclasses.replace(g, grid=one) if kernel.key == "b3" else one
    if kernel.key == "b3_3d":       # the route's two kernels, both split
        clean = wrapper.last_clean_geometry
        n = args[0].shape[0]

        def launch(*a):
            return mod.launch_3d_split(*a[:-1], a[-1][1], a[-1][0])
        g = (g, clean)
        unsplit = tuple(dataclasses.replace(x, n_split=1, cells_per_split=n)
                        for x in g)
    same = torch.equal(out, launch(*args, g))
    ms = {"split": [], "no split": []}
    for which, geom in (("split", g), ("no split", unsplit),
                        ("no split", unsplit), ("split", g)):
        ms[which].append(cuda_ms(lambda: launch(*args, geom)))
    print(f"{kernel.key} first {n_species} species ({n_mom} momenta, "
          f"{grid.blocks} blocks): split in {grid.n_split} "
          f"{ms['split'][0]:.1f} {ms['split'][1]:.1f} ms, no split "
          f"{ms['no split'][0]:.1f} {ms['no split'][1]:.1f} ms "
          f"({min(ms['no split']) / min(ms['split']):.2f}x); repeats {same}")
    return {"blocks": grid.blocks, "n_split": grid.n_split, **ms}


def race_branches(ops, cfg: Config) -> dict:
    """B3's 3+1d mixed kernel (both branches; ``launch_3d``) on every cell
    of ``ops`` three ways, timed twice each in mirrored order: as packed,
    with every cell on the modified branch (BREAKS_3 and WINDOW_3 zeroed)
    and with every cell on the linearised one (BREAKS_3 = 1); beside them
    the route split by cell on the packed operands.  From the middle two,
    each branch's ms per 1e12 evaluations, and the time each takes of the
    packed run at its real mix of evaluations."""
    from ..ops import cooper_frye_feqmod as fk
    lib = _build.load("cooper_frye_feqmod")
    C, M = ops.cols.shape[0], ops.mom.shape[1]
    g = fk.geometry_3d(ops.mom, C, ops.n_y,
                       fk.Tile3d.of(lib, "cooper_frye_feqmod_3d"),
                       ops.row_len)
    modified_cols, linearised_cols = ops.cols.clone(), ops.cols.clone()
    modified_cols[:, fk.BREAKS_3] = 0.0
    linearised_cols[:, fk.BREAKS_3] = 1.0
    modified_cold = ops.cold.clone()
    modified_cold[:, fk.WINDOW_3] = 0.0
    variants = {"as packed": (ops.cols, ops.cold),
                "all modified": (modified_cols, modified_cold),
                "all linearised": (linearised_cols, ops.cold)}

    args = (ops.mom, ops.y, ops.renorm, ops.red, ops.n_per_species, cfg,
            ops.kind)
    calls = {label: functools.partial(fk.launch_3d, cols, cold, *args, g, lib)
             for label, (cols, cold) in variants.items()}
    if hasattr(lib, "is3d2_cooper_frye_feqmod_3d_split"):
        # the route, split by cell, on the packed operands
        g_clean = fk.geometry_3d(ops.mom, C, ops.n_y, fk.Tile3d.of(
            lib, "cooper_frye_feqmod_3d_clean"), ops.row_len)
        calls["split route"] = functools.partial(
            fk.launch_3d_split, ops.cols, ops.cold, *args, g_clean, g, lib)
    for call in calls.values():
        call()                             # warm-up
    ms = {label: [] for label in calls}
    for label in list(calls) + list(reversed(calls)):
        ms[label].append(cuda_ms(calls[label]))
    brk = ops.cols[:, fk.BREAKS_3] != 0
    n_lin = (int(brk.sum()) * M
             + int((ops.window() & ~brk[:, None]).sum()) * (M // ops.n_y))
    n_mod = C * M - n_lin
    per = {label: min(v) / (C * M) * 1e12 for label, v in ms.items()}
    share = {"modified": per["all modified"] * n_mod / 1e12,
             "linearised": per["all linearised"] * n_lin / 1e12}
    packed = min(ms["as packed"])
    record = {"geometry": dataclasses.asdict(g), "ms": ms,
              "n_clean": int(ops.n_clean),
              "ms_per_1e12_evaluations": per,
              "evaluations": {"modified": n_mod, "linearised": n_lin},
              "predicted_ms_of_packed_run": share,
              "share_of_packed_run": {k: v / packed
                                      for k, v in share.items()}}
    for label, v in ms.items():
        print(f"b3_3d branches, {label:15s} {v[0]:9.1f} {v[1]:9.1f} ms  "
              f"{per[label]:9.1f} ms per 1e12 evaluations")
    print(f"b3_3d branches: as packed {n_mod} modified and {n_lin} "
          f"linearised evaluations ({n_lin / (C * M):.4f} of them); at "
          f"the one-branch rates the modified ones take "
          f"{share['modified']:.1f} ms and the linearised ones "
          f"{share['linearised']:.1f} ms of the packed run's {packed:.1f} ms"
          f" ({share['modified'] / packed:.3f} + "
          f"{share['linearised'] / packed:.3f})")
    return record


def p1_tree_call(package: str, wd: Path, cfg: Config, surf):
    """(call, args) of one tree's P1 on a mode-5 workdir's operands, packed
    as that tree's route packs them."""
    tkc = importlib.import_module(f"{package}.tools.kernel_check")
    tpz = importlib.import_module(f"{package}.ops.polarization_f32")
    state = tkc.polarization_engine_state(wd, cfg, surf, "cuda")
    if hasattr(tkc, "polarization_operands"):
        ops = tkc.polarization_operands(state, cfg)
    else:                            # a tree from before P1's eta fold
        ops = tpz.pack_inputs(*state)
    return (functools.partial(tpz.polarization_f32, row_len=ops.row_len),
            ops.args())


def race_p1(packages: dict, wd: Path, n_compare: int) -> dict:
    """Time every tree's P1 on the workdir's operands (twice, mirrored
    order) and hold it to this tree's plain version on the first
    ``n_compare`` cells (the same real cells in every tree: padding, where
    a tree packs it, comes last)."""
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", 5, 2, False)
    calls = {label: p1_tree_call(package, wd, cfg, surf)
             for label, package in packages.items()}
    mine = importlib.import_module(
        f"{packages[THIS_TREE]}.ops.polarization_f32")

    def cut(args):
        return (args[0][:n_compare].contiguous(), *args[1:])

    ref = mine.polarization_f32_plain(*cut(calls[THIS_TREE][1]))
    ref = ref.cpu().numpy()
    results = {}
    for label, (call, args) in calls.items():
        out = call(*cut(args))             # builds are done; this warms up
        again = call(*cut(args))
        results[label] = {
            "ms": [], "cells": args[0].shape[0], "eta": args[1].shape[0],
            "vs_plain": kc.polarization_errors(out.cpu().numpy(), ref),
            "repeats": bool(torch.equal(out, again)),
            "finite": bool(torch.isfinite(out).all())}
    for label in list(calls) + list(reversed(calls)):
        call, args = calls[label]
        results[label]["ms"].append(cuda_ms(lambda: call(*args)))
    mine_ms = min(results[THIS_TREE]["ms"])
    for label, r in results.items():
        note = ""
        if label == THIS_TREE:
            ok = (r["finite"] and r["repeats"]
                  and max(r["vs_plain"]) <= kc.POLZN_TOL_PLAIN)
            note = "  ok" if ok else "  MISSES ITS BAR"
        print(f"p1 {label:20s} {r['ms'][0]:9.1f} {r['ms'][1]:9.1f} ms  "
              f"{min(r['ms']) / mine_ms:.3f}x this tree's  ({r['cells']} "
              f"cells x {r['eta']} eta)  vs this tree's plain version: Snorm"
              f" {r['vs_plain'][0]:.3e}, P {r['vs_plain'][1]:.3e}  repeats "
              f"{r['repeats']}{note}")
    return results


def race_p1_3d(packages: dict, wd: Path, n_compare: int) -> dict:
    """Time every tree's P1 3+1d mode on the 3+1d mode-5 workdir's
    operands (twice, mirrored order), hold it to this tree's plain version
    on the first ``n_compare`` cells at the polarization bars, and compare
    its bits at full size with this tree's (the same runs of cells at
    every tile)."""
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", 5, 3, False)
    calls = {}
    for label, package in packages.items():
        tkc = importlib.import_module(f"{package}.tools.kernel_check")
        tpz = importlib.import_module(f"{package}.ops.polarization_f32")
        if not hasattr(tkc, "polarization_operands_3d"):
            print(f"p1_3d {label}: no 3+1d mode")
            continue
        ops = tkc.polarization_operands_3d(
            tkc.polarization_engine_state(wd, cfg, surf, "cuda"))
        calls[label] = (functools.partial(tpz.polarization_f32_3d,
                                          **ops.layout()), ops, tpz)
    _, ops, mine = calls[THIS_TREE]
    ref = mine.polarization_f32_3d_plain(*ops.first(n_compare).args(),
                                         **ops.layout()).cpu().numpy()
    full = calls[THIS_TREE][0](*ops.args())
    results = {}
    for label, (call, ops, tpz) in calls.items():
        cut = ops.first(n_compare)
        out = call(*cut.args())
        again = call(*cut.args())
        same = bool(torch.equal(call(*ops.args()), full))
        results[label] = {
            "ms": [], "geometry": str(tpz.polarization_f32_3d.last_geometry),
            "vs_plain": kc.polarization_errors(out.cpu().numpy(), ref),
            "repeats": bool(torch.equal(out, again)),
            "finite": bool(torch.isfinite(out).all()),
            "equal_bits_at_full_size": same}
    del full
    for label in list(calls) + list(reversed(calls)):
        call, ops, _ = calls[label]
        results[label]["ms"].append(cuda_ms(lambda: call(*ops.args())))
    mine_ms = min(results[THIS_TREE]["ms"])
    evaluations = calls[THIS_TREE][1].evaluations
    for label, r in results.items():
        ok = (r["finite"] and r["repeats"]
              and max(r["vs_plain"]) <= kc.POLZN_TOL_PLAIN)
        r["evaluations_per_s"] = evaluations / min(r["ms"]) * 1e3
        print(f"p1_3d {label:20s} {r['ms'][0]:9.1f} {r['ms'][1]:9.1f} ms  "
              f"{min(r['ms']) / mine_ms:.3f}x this tree's  "
              f"{r['evaluations_per_s']:.4g} evaluations/s  vs this tree's "
              f"plain version: Snorm {r['vs_plain'][0]:.3e}, P "
              f"{r['vs_plain'][1]:.3e}  repeats {r['repeats']}  equal bits "
              f"{r['equal_bits_at_full_size']}  "
              f"{'ok' if ok else 'MISSES ITS BAR'}  {r['geometry']}")
    return results


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


# B1's per-cell mode (operation 0): threads a block x blocks an SM
# (--tile-cells).  A species of the full grid has 612 register tiles: 640x1
# pads it to 20 warps in one pass, 128x4, 320x2, 160x3 and 64x8 walk it in
# passes over the same 640 lanes, 256x2 over 768
TILES_CELLS = ("128x4", "640x1", "320x2", "160x3", "64x8", "256x2")
TILE_LINE_CELLS = r"constexpr int kThreadsC = \d+, kMinBlocksC = \d+;"
# B1's bound: FP32 operations an evaluation (chip_smoke.py's
# BOUND_OPS_PER_EVALUATION) at the H100's 67e12 FP32 operations a second;
# its operands' bytes are far below the operations
B1_BOUND_OPS = 48.75
PEAK_FP32_OPS = 67e12


def cells_tile_tree(spec: str, root: Path) -> Path:
    """A copy of this tree under ``root`` whose per-cell mode launches
    ``spec`` = "TxB" (threads a block, blocks an SM; see TILES_CELLS)."""
    t, b = (int(v) for v in spec.split("x"))
    return _tree_copy(root / f"cells_{spec}", "cooper_frye_comp",
                      TILE_LINE_CELLS,
                      f"constexpr int kThreadsC = {t}, kMinBlocksC = {b};")


def race_cells(packages: dict, wd: Path, n_compare: int) -> dict:
    """Every tree's per-cell mode on the df-1 f32c operands of the
    workdir's surface (the op-0 route's: every live cell, eta folded),
    timed twice in mirrored order beside this tree's op-1 kernel on the
    same operands; each held to this tree's plain version on the first
    ``n_compare`` cells (per (cell, species)) and to this tree's result
    at full size; its time against B1's bound."""
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", 1, cfg.dimension, False)
    state = kc.engine_state(wd, cfg, surf, "cuda")
    ops = comp_operands(*state, cfg)
    live = torch.nonzero(state[0].mask > 0.0)[:, 0]
    cell, qm = ops.cell[live].contiguous(), ops.qm[live].contiguous()
    grid = state[3]
    w = (grid.pT_weight[:, None] * grid.phi_weight[None, :]).reshape(-1)
    args = (cell, qm, ops.eta, ops.eta_w, ops.mom, w.contiguous(), cfg)
    cut = (cell[:n_compare].contiguous(), qm[:n_compare].contiguous(),
           *args[2:])
    evaluations = cell.shape[0] * ops.eta.shape[0] * ops.mom.shape[1]
    bound_ms = B1_BOUND_OPS * evaluations / PEAK_FP32_OPS * 1e3
    print(f"b1_cells: {cell.shape[0]} live cells x {ops.eta.shape[0]} eta x "
          f"{ops.mom.shape[1]} momenta = {evaluations:.4g} evaluations; "
          f"bound {bound_ms:.1f} ms")
    calls = {}
    for label, package in packages.items():
        mod = importlib.import_module(f"{package}.ops.cooper_frye_comp")
        if not hasattr(mod, "cooper_frye_comp_cells"):
            print(f"b1_cells {label}: no per-cell mode")
            continue
        calls[label] = (functools.partial(mod.cooper_frye_comp_cells,
                                          row_len=ops.row_len), mod)
    mine = calls[THIS_TREE][1]
    ref = mine.cooper_frye_comp_cells_plain(*cut).cpu().numpy()
    scale = kc.cells_scale(*cut)
    full = calls[THIS_TREE][0](*args)
    results = {}
    for label, (call, mod) in calls.items():
        out = call(*cut)
        results[label] = {
            "geometry": str(mod.cooper_frye_comp_cells.last_geometry),
            "vs_plain": kc.max_scaled_err(out.cpu().numpy(), ref, scale),
            "vs_plain_relative": kc.max_rel_err(out.T.cpu().numpy(), ref.T),
            "repeats": bool(torch.equal(out, call(*cut))),
            "finite": bool(torch.isfinite(out).all()),
            "vs_this_tree": kc.max_rel_err(call(*args).T.cpu().numpy(),
                                           full.T.cpu().numpy()),
            "ms": []}
    del full
    timed = {label: functools.partial(call, *args)
             for label, (call, _) in calls.items()}
    timed["op-1 kernel"] = functools.partial(
        mine.cooper_frye_comp, *args[:5], cfg, row_len=ops.row_len)
    results["op-1 kernel"] = {"ms": []}
    timed["op-1 kernel"]()
    for label in list(timed) + list(reversed(timed)):
        results[label]["ms"].append(cuda_ms(timed[label]))
    op1 = min(results["op-1 kernel"]["ms"])
    for label, r in results.items():
        ms = min(r["ms"])
        r.update(bound_ms=bound_ms, bound_pct=100.0 * bound_ms / ms,
                 evaluations_per_s=evaluations / ms * 1e3)
        line = (f"b1_cells {label:20s} {r['ms'][0]:9.1f} {r['ms'][1]:9.1f} ms"
                f"  {ms / op1:.3f}x the op-1 kernel's  bound "
                f"{r['bound_pct']:.2f} %")
        if "vs_plain" in r:
            ok = (r["finite"] and r["repeats"] and r["vs_plain"] <= kc.TOL
                  and r["vs_this_tree"] <= kc.TOL)
            line += (f"  vs this tree's plain version {r['vs_plain']:.3e} "
                     f"of the cells' |terms| ({r['vs_plain_relative']:.3e} "
                     f"relative), "
                     f"vs this tree {r['vs_this_tree']:.3e}  repeats "
                     f"{r['repeats']}  {'ok' if ok else 'MISSES ITS BAR'}  "
                     f"{r['geometry']}")
        print(line)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="another version of the package to time beside "
                         "this one (repeatable)")
    ap.add_argument("--only", default="b1,b3,b2")
    ap.add_argument("--tile3d", action="append", default=[],
                    metavar="PxYxTxB",
                    help="a copy of this tree whose 3+1d mode launches this "
                         "tile (repeatable; TILES_3D lists the raced ones)")
    ap.add_argument("--tile3d-b3", action="append", default=[],
                    metavar="PxYxTxB",
                    help="the same for B3's 3+1d mode (TILES_3D_B3)")
    ap.add_argument("--tile3d-p1", action="append", default=[],
                    metavar="PxYxTxB",
                    help="the same for P1's 3+1d mode (TILES_3D_P1)")
    ap.add_argument("--tile-cells", action="append", default=[],
                    metavar="TxB",
                    help="a copy of this tree whose per-cell mode (b1_cells)"
                         " launches T threads a block, B blocks an SM "
                         "(repeatable; TILES_CELLS lists the raced ones)")
    ap.add_argument("--branches", action="store_true",
                    help="with b3_3d: time its mixed kernel with every cell "
                         "on one branch (race_branches)")
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
    trees = [item.partition("=")[::2] for item in a.tree]
    trees += [(f"tile {spec}", tile_tree(spec, Path("build/tile3d")))
              for spec in a.tile3d]
    trees += [(f"b3 tile {spec}", tile_tree(spec, Path("build/tile3d"),
                                            "cooper_frye_feqmod"))
              for spec in a.tile3d_b3]
    trees += [(f"p1 tile {spec}", tile_tree(spec, Path("build/tile3d"),
                                            "polarization_f32"))
              for spec in a.tile3d_p1]
    trees += [(f"cells {spec}", cells_tile_tree(spec, Path("build/tile3d")))
              for spec in a.tile_cells]
    for i, (label, directory) in enumerate(trees):
        packages[label] = load_tree(i, Path(directory)).__name__
    only = a.only.split(",")
    kernels = [k for k in KERNELS if k.key in only]
    few_species = [int(s) for s in a.few_species.split(",") if s]

    # every tree's sources, one nvcc each, all at once
    builds = {(k.module, package) for k in kernels
              for package in packages.values()}
    if {"p1", "p1_3d"} & set(only):
        builds |= {("polarization_f32", package)
                   for package in packages.values()}
    if "b1_cells" in only:
        builds |= {("cooper_frye_comp", package)
                   for package in packages.values()}
    with concurrent.futures.ThreadPoolExecutor(len(builds) or 1) as pool:
        list(pool.map(lambda mp: importlib.import_module(
            f"{mp[1]}.ops._build").build(mp[0]), builds))
    record = {"card": card, "cells": a.cells, "builds": {}, "kernels": {}}
    failed = []
    for k in kernels:
        for label, package in packages.items():
            record["builds"][f"{k.key} {label}"] = report_build(
                f"{k.key} [{label}]", k.name, k.library(package))
            if k.key == "b3_3d":    # its clean kernel
                record["builds"][f"{k.key} clean {label}"] = report_build(
                    f"{k.key} clean [{label}]", k.name + "_clean",
                    k.library(package))
    for key, name, source in (
            ("p1", "polarization_f32", "polarization_f32"),
            ("p1_3d", "polarization_f32_3d", "polarization_f32"),
            ("b1_cells", "cooper_frye_comp_cells", "cooper_frye_comp")):
        if key not in only:
            continue
        for label, package in packages.items():
            build = importlib.import_module(f"{package}.ops._build")
            record["builds"][f"{key} {label}"] = report_build(
                f"{key} [{label}]", name, build.build(source)[0],
                P1_3D_UNIT if key == "p1_3d" else "MUFU.EX2")

    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = Path("build")
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for k in kernels:
            wd = write_workdir(Path(tmp) / k.key, n_cells=a.cells,
                               params=k.params, **k.surface)
            cfg, state, ops, args, cut, few = operands(k, wd)
            eta = f"{ops.eta.shape[0]} eta x " if hasattr(ops, "eta") else ""
            print(f"{k.key}: {args[0].shape[0]} cells x {eta}"
                  f"{ops.mom.shape[1]} momenta = {ops.evaluations:.4g} "
                  "evaluations")
            # as the main path calls them: with the phi count (and the y
            # count), where a tree's wrapper takes it
            layout = {"row_len": ops.row_len, "n_y": getattr(ops, "n_y", 1)}
            versions = {}
            for label, package in packages.items():
                call = k.wrapper(package)
                given = {key: v for key, v in layout.items()
                         if key in inspect.signature(call).parameters}
                versions[label] = functools.partial(call, **given)
            mine = importlib.import_module(
                f"{packages[THIS_TREE]}.ops.{k.module}")
            plain = getattr(mine, f"{k.name}_plain")
            plain = functools.partial(plain, **{
                key: v for key, v in layout.items()
                if key in inspect.signature(plain).parameters})
            rec, spectra = race(k, versions, args, cut(a.compare_cells),
                                plain, state)
            print(f"{k.key}: geometry {getattr(mine, k.name).last_geometry}")
            if k.key in MODES_3D:
                rec["vs_this_tree"] = equal_bits(k, versions, packages, args)
                failed += [f"{k.key} {label}: bits differ"
                           for label, r in rec["vs_this_tree"].items()
                           if not r["equal_bits"]]
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
            if k.key == "b3_3d" and a.branches:
                rec["branches"] = race_branches(ops, cfg)
            rec["few_species"] = {
                s: race_split(k, few, s,
                              {"n_y": ops.n_y} if k.key in MODES_3D else {})
                for s in few_species}
            record["kernels"][k.name] = rec
            del ops, args, cut, few, state, versions
            torch.cuda.empty_cache()
        if "p1" in only:
            wd = write_workdir(Path(tmp) / "p1", n_cells=a.cells,
                               params={"df_mode": 1, "compute_dtype": "f32c"},
                               surface_mode=5)
            record["p1"] = race_p1(packages, wd, a.compare_cells)
        if "p1_3d" in only:
            wd = write_workdir(Path(tmp) / "p1_3d", n_cells=a.cells,
                               params={"df_mode": 1, "compute_dtype": "f32c"},
                               surface_mode=5, dimension=3)
            record["p1_3d"] = race_p1_3d(packages, wd, a.compare_cells)
            failed += [f"p1_3d {label}: misses its bar"
                       for label, r in record["p1_3d"].items()
                       if not (r["finite"] and r["repeats"] and
                               max(r["vs_plain"]) <= kc.POLZN_TOL_PLAIN)]
        if "b1_cells" in only:
            wd = write_workdir(Path(tmp) / "b1_cells", n_cells=a.cells,
                               params={"df_mode": 1, "compute_dtype": "f32c"})
            record["b1_cells"] = race_cells(packages, wd, a.compare_cells)
            failed += [f"b1_cells {label}: misses its bar"
                       for label, r in record["b1_cells"].items()
                       if "vs_plain" in r and not (
                           r["finite"] and r["repeats"]
                           and r["vs_plain"] <= kc.TOL
                           and r["vs_this_tree"] <= kc.TOL)]
        if "prep" in only:
            wd = write_workdir(Path(tmp) / "prep", n_cells=16)
            record["prep"] = race_prep(packages, wd, a.cells)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(record, indent=1))
    print(card)
    for line in failed:
        print("FAILED:", line)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
