"""Post-run analysis tools: sampled-vs-smooth comparison, spectra plots,
event histograms, and hic-eventgen-style observables.

The port's copy of is3d2_tpu/tools/analysis.py: replacements for the
reference's analysis scripts (scripts/compare_sampling_smooth.py,
scripts/plot_spectra.py, scripts/histogram_event.py,
scripts/compute_observables.py) on the result files that both packages
write (io/output.py).  It reads files only, runs nothing on a device and
imports no jax: compute_observables reads the PDG list with the port's
io/pdg.py.  Plotting is optional (gated on matplotlib); every numeric
result (the dicts and the .npz) comes out without it.

CLI:
    python -m is3d2_tpu_torch.tools.analysis compare  <workdir> [mcid ...]
    python -m is3d2_tpu_torch.tools.analysis spectra  <workdir> [mcid ...]
    python -m is3d2_tpu_torch.tools.analysis event    <particle_list.dat>
    python -m is3d2_tpu_torch.tools.analysis observables <workdir> [--out obs.npz]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

# (name, mcid) pairs used for identified-particle observables, matching the
# hic-eventgen list in scripts/compute_observables.py:25-33
IDENTIFIED = [("pion", 211), ("kaon", 321), ("proton", 2212),
              ("Lambda", 3122), ("Sigma0", 3212), ("Xi", 3312),
              ("Omega", 3334)]


def _maybe_pyplot():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def load_smooth_dN_2pipTdpTdy(results_dir, mcid, y_value=0.0):
    """(pT, dN/2pi pT dpT dy) at one rapidity from the continuous results."""
    d = np.loadtxt(Path(results_dir) / "continuous" / f"dN_2pipTdpTdy_{mcid}.dat")
    d = np.atleast_2d(d)
    sel = np.isclose(d[:, 0], y_value)
    return d[sel, 1], d[sel, 2]


def load_sampled_dN_2pipTdpTdy(results_dir, mcid):
    d = np.loadtxt(Path(results_dir) / "sampled" / "dN_2pipTdpTdy"
                   / f"dN_2pipTdpTdy_{mcid}_test.dat")
    d = np.atleast_2d(d)
    return d[:, 0], d[:, 1]


def compare_sampling_smooth(workdir, mcids=(211, 321, 2212), out_png=None):
    """Overlay event-averaged sampled pT spectra on the smooth CF spectra
    and report the statistics-weighted yield ratio plus the mean per-bin
    deviation (the reference's validation plot,
    scripts/compare_sampling_smooth.py).

    For the two to agree, the smooth run must use outflow=1 and
    regulate_deltaf=1: the sampler always drops inflowing hadrons
    (w_flux = max(0, p.dsigma)) and clamps |df| <= 1 in its acceptance
    weight (ParticleSampler.cpp:969)."""
    results = Path(workdir) / "results"
    plt = _maybe_pyplot()
    fig = ax = None
    if plt is not None:
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
    report = {}
    for mcid in mcids:
        pT_s, smooth = load_smooth_dN_2pipTdpTdy(results, mcid)
        pT_h, sampled = load_sampled_dN_2pipTdpTdy(results, mcid)
        smooth_i = np.interp(pT_h, pT_s, smooth)
        sel = (sampled > 0) & (smooth_i > 0)
        ratio = sampled[sel] / smooth_i[sel]
        # integrated dN/dy ratio (statistics-weighted: tails contribute
        # little) plus the per-bin deviation in the populated region
        w = pT_h[sel]
        yield_ratio = (np.sum(sampled[sel] * w) / np.sum(smooth_i[sel] * w)
                       if sel.any() else np.nan)
        report[mcid] = {
            "mean_dev": float(np.abs(ratio - 1.0).mean()) if sel.any() else np.nan,
            "yield_ratio": float(yield_ratio),
        }
        if ax is not None:
            line, = ax.plot(pT_s, smooth, "-", label=f"{mcid} smooth")
            ax.plot(pT_h, sampled, "o", ms=3, color=line.get_color(),
                    label=f"{mcid} sampled")
    if ax is not None:
        ax.set_yscale("log")
        ax.set_xlabel(r"$p_T$ [GeV]")
        ax.set_ylabel(r"$dN/2\pi p_T dp_T dy$ [GeV$^{-2}$]")
        ax.legend(fontsize=7)
        fig.tight_layout()
        out = out_png or (results / "sampled_vs_smooth.png")
        fig.savefig(out, dpi=130)
        print(f"wrote {out}")
    for mcid, r in report.items():
        print(f"  mcid {mcid}: yield ratio = {r['yield_ratio']:.4f}, "
              f"mean per-bin |sampled/smooth - 1| = {r['mean_dev']:.3f}")
    return report


def plot_spectra(workdir, mcids=(211, 321, 2212), out_png=None):
    """Midrapidity invariant-pT-spectra plot (scripts/plot_spectra.py)."""
    results = Path(workdir) / "results"
    plt = _maybe_pyplot()
    if plt is None:
        print("matplotlib unavailable; printing values instead")
        for mcid in mcids:
            pT, v = load_smooth_dN_2pipTdpTdy(results, mcid)
            print(f"mcid {mcid}: pT[0]={pT[0]:.3f} val[0]={v[0]:.5e} "
                  f"pT[-1]={pT[-1]:.3f} val[-1]={v[-1]:.5e}")
        return None
    fig, ax = plt.subplots(figsize=(5.0, 4.2))
    for mcid in mcids:
        pT, v = load_smooth_dN_2pipTdpTdy(results, mcid)
        ax.plot(pT, v, "-", label=str(mcid))
    ax.set_yscale("log")
    ax.set_xlabel(r"$p_T$ [GeV]")
    ax.set_ylabel(r"$dN/2\pi p_T dp_T dy$ [GeV$^{-2}$]")
    ax.legend()
    fig.tight_layout()
    out = out_png or (results / "spectra.png")
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")
    return out


def read_particle_list(path):
    """Read a CSV particle list (io/output.write_particle_list_csv format:
    mcid,tau,x,y,eta,E,px,py,pz) into a dict of arrays with derived
    kinematics (pT, mT, phi, y_rap, eta_p).  numpy's C reader (loadtxt)
    gives the values of the JAX tool's genfromtxt, several times faster:
    an event of 1.5e5 hadrons in ~0.1 s."""
    with open(path) as fh:
        names = fh.readline().strip().split(",")
        data = np.loadtxt(fh, delimiter=",", ndmin=2)
    raw = dict(zip(names, data.reshape(-1, len(names)).T))
    E, px, py, pz = raw["E"], raw["px"], raw["py"], raw["pz"]
    pT = np.hypot(px, py)
    p = np.sqrt(px * px + py * py + pz * pz)
    with np.errstate(divide="ignore", invalid="ignore"):
        y_rap = 0.5 * np.log((E + pz) / np.maximum(E - pz, 1e-300))
        eta_p = 0.5 * np.log((p + pz) / np.maximum(p - pz, 1e-300))
    return {
        "mcid": raw["mcid"].astype(np.int64),
        "tau": raw["tau"], "x": raw["x"], "y": raw["y"], "eta_s": raw["eta"],
        "E": E, "px": px, "py": py, "pz": pz,
        "pT": pT, "phi": np.arctan2(py, px), "y_rap": y_rap, "eta_p": eta_p,
        "mass": np.sqrt(np.maximum(E * E - p * p, 0.0)),
    }


def histogram_event(path, out_png=None, mcids=(211, 321, 2212)):
    """Per-species pT / phi / y histograms of one sampled event
    (scripts/histogram_event.py)."""
    parts = read_particle_list(path)
    plt = _maybe_pyplot()
    print(f"{path}: {len(parts['E'])} hadrons, "
          f"{len(np.unique(parts['mcid']))} species")
    stats = {}
    for mcid in mcids:
        sel = parts["mcid"] == mcid
        n = int(sel.sum())
        stats[mcid] = {"n": n,
                       "mean_pT": float(parts["pT"][sel].mean()) if n else np.nan}
        print(f"  mcid {mcid}: N={n} <pT>="
              f"{stats[mcid]['mean_pT']:.4f} GeV")
    if plt is not None:
        fig, axes = plt.subplots(1, 3, figsize=(11, 3.4))
        for mcid in mcids:
            sel = parts["mcid"] == mcid
            axes[0].hist(parts["pT"][sel], bins=40, range=(0, 3),
                         histtype="step", label=str(mcid))
            axes[1].hist(parts["phi"][sel], bins=40,
                         range=(-np.pi, np.pi), histtype="step")
            axes[2].hist(parts["y_rap"][sel], bins=40, range=(-5, 5),
                         histtype="step")
        for ax, lab in zip(axes, (r"$p_T$ [GeV]", r"$\phi_p$", r"$y$")):
            ax.set_xlabel(lab)
        axes[0].legend(fontsize=7)
        fig.tight_layout()
        out = out_png or (str(path) + ".png")
        fig.savefig(out, dpi=130)
        print(f"wrote {out}")
    return stats


def compute_observables(workdir, n_events=None, charge_lookup=None,
                        eta_ch=0.5, eta_flow=(0.2, 0.8), pT_flow=(0.2, 5.0),
                        out=None):
    """hic-eventgen-style per-event observables from the sampled particle
    lists (scripts/compute_observables.py → results array): charged
    multiplicity dNch/deta and transverse energy dET/deta at midrapidity,
    identified dN/dy and <pT>, pT-fluctuation accumulators, and the complex
    flow vectors Q_n (n=1..8) in the flow acceptance window.

    charge_lookup: dict mcid -> charge; built from the PDG table when None
    (requires the workdir PDG/ directory).
    """
    workdir = Path(workdir)
    results = workdir / "results"
    if charge_lookup is None:
        from ..io.pdg import read_pdg
        charge_lookup = {}
        for eos in (3, 2, 1):
            try:
                table = read_pdg(eos, workdir / "PDG")
            except Exception:
                continue
            for sp in table.species:
                charge_lookup.setdefault(int(sp.mc_id), sp.charge)
            break

    files = sorted(results.glob("particle_list_[0-9]*.dat"),
                   key=lambda p: int(p.stem.split("_")[-1]))
    if n_events is not None:
        files = files[:n_events]
    if not files:
        raise FileNotFoundError(f"no particle_list_*.dat under {results}")

    events = []
    for f in files:
        parts = read_particle_list(f)
        mcids, at = np.unique(parts["mcid"], return_inverse=True)
        charge = np.array([charge_lookup.get(int(m), 0) for m in mcids],
                          dtype=np.int64)[at]
        mid = np.abs(parts["eta_p"]) < eta_ch
        ch = charge != 0
        ET = np.hypot(parts["mass"], parts["pT"])
        ev = {"dNch_deta": float((mid & ch).sum() / (2.0 * eta_ch)),
              "dET_deta": float(ET[mid].sum() / (2.0 * eta_ch))}
        for name, mcid in IDENTIFIED:
            sel = np.abs(parts["mcid"]) == mcid
            midy = sel & (np.abs(parts["y_rap"]) < 0.5)
            ev[f"dN_dy_{name}"] = float(midy.sum())
            ev[f"mean_pT_{name}"] = (float(parts["pT"][sel].mean())
                                     if sel.any() else 0.0)
        fl = (ch & (np.abs(parts["eta_p"]) > eta_flow[0])
              & (np.abs(parts["eta_p"]) < eta_flow[1])
              & (parts["pT"] > pT_flow[0]) & (parts["pT"] < pT_flow[1]))
        phi = parts["phi"][fl]
        ev["flow_N"] = int(fl.sum())
        ev["Qn"] = np.array([np.exp(1j * n * phi).sum() for n in range(1, 9)])
        pf = ch & (parts["pT"] > 0.15) & (parts["pT"] < 2.0) \
            & (np.abs(parts["eta_p"]) < 0.8)
        ev["pT_fluct_N"] = int(pf.sum())
        ev["pT_fluct_sum"] = float(parts["pT"][pf].sum())
        ev["pT_fluct_sumsq"] = float((parts["pT"][pf] ** 2).sum())
        events.append(ev)

    keys = [k for k in events[0] if k != "Qn"]
    obs = {k: np.array([e[k] for e in events]) for k in keys}
    obs["Qn"] = np.stack([e["Qn"] for e in events])
    out = out or (results / "observables.npz")
    np.savez(out, **obs)
    print(f"{len(events)} events -> {out}")
    print(f"  <dNch/deta> = {obs['dNch_deta'].mean():.2f}")
    for name, _ in IDENTIFIED[:3]:
        print(f"  <dN/dy {name}> = {obs[f'dN_dy_{name}'].mean():.2f}  "
              f"<pT> = {obs[f'mean_pT_{name}'].mean():.4f} GeV")
    # 2-particle cumulant elliptic flow estimate over the ensemble
    N = obs["flow_N"].astype(float)
    pairs = N * (N - 1)
    if pairs.sum() > 0:
        c2 = ((np.abs(obs["Qn"][:, 1]) ** 2 - N).sum()) / pairs.sum()
        if c2 > 0:
            print(f"  v2{{2}} = {np.sqrt(c2):.4f}")
    return obs


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd == "compare":
        wd = args[0]
        mcids = tuple(int(a) for a in args[1:]) or (211, 321, 2212)
        compare_sampling_smooth(wd, mcids)
    elif cmd == "spectra":
        wd = args[0]
        mcids = tuple(int(a) for a in args[1:]) or (211, 321, 2212)
        plot_spectra(wd, mcids)
    elif cmd == "event":
        histogram_event(args[0])
    elif cmd == "observables":
        out = None
        if "--out" in args:
            i = args.index("--out")
            out = args[i + 1]
            args = args[:i] + args[i + 2:]
        compute_observables(args[0], out=out)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
