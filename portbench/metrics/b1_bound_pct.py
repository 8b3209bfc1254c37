"""b1_bound_pct: the least time the card could take for the 2+1d df-1
evaluations the window's surfaces need, over kernel B1's device time
(the kernel and its partial-sum adds).

Evaluations of a surface: live cells (u.dsigma > 0) x eta nodes (half of
them where the surface is boost-invariant, as the eta fold allows) x
species x pT x phi; operations: harness/bounds.py's B1 count each."""

from portbench.harness import bounds

PATTERNS = (r"cooper_frye_comp_kernel", r"add_partials")
ODD = ("un", "dan", "pixn", "piyn")


def read(ctx):
    inp = ctx.cfg["inputs"]
    n_mom = ctx.n_species * inp["n_pT"] * inp["n_phi"]
    need = took = 0.0
    for r in ctx.records:
        k = ctx.kernel_s(r.index, PATTERNS)
        if not k:
            return None
        s = ctx.surfaces[r.surface]
        folded = inp["dimension"] == 2 and not any(s[f].any() for f in ODD)
        n_eta = inp["n_eta"] // 2 if folded else inp["n_eta"]
        ev = ctx.live_cells(r.surface) * n_eta * n_mom
        need += bounds.bound_seconds(
            bounds.B1_OPS_PER_EVALUATION * ev,
            bounds.bytes_moved(inp["n_cells"], n_mom * inp["n_y"]))
        took += k
    return 100.0 * need / took
