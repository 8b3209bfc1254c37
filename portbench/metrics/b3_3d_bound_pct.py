"""b3_3d_bound_pct: the least time the card could take for the 3+1d df-4
evaluations the window's surfaces need, over the device time of kernel
B3's 3+1d route (the clean kernel, the mixed kernel and the partial-sum
adds).

Evaluations of a surface: live cells x y x species x pT x phi, each
(cell, y) row counted in the branch the reference's classification gives
it (modified, or linearised where the cell breaks down or the row lies in
the narrow window); operations: harness/bounds.py's B3 3+1d counts."""

from portbench.harness import bounds

PATTERNS = (r"cooper_frye_feqmod_3d", r"add_partials")


def read(ctx):
    inp = ctx.cfg["inputs"]
    n_mom = ctx.n_species * inp["n_pT"] * inp["n_phi"]
    per = bounds.B3_3D_OPS_PER_EVALUATION
    need = took = 0.0
    for r in ctx.records:
        k = ctx.kernel_s(r.index, PATTERNS)
        if not k:
            return None
        mod, lin = ctx.branch_rows(r.surface)
        ops = n_mom * (mod * per["modified"] + lin * per["linearised"])
        need += bounds.bound_seconds(
            ops, bounds.bytes_moved(inp["n_cells"], n_mom * inp["n_y"]))
        took += k
    return 100.0 * need / took
