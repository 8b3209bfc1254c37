"""PDG hadron-resonance-gas readers.

Replaces the reference's PDG_Data readers (src/cpp/readindata.cpp:973-1252)
and the MC-ID property decoder read_mcid (readindata.cpp:734-957).

Two file formats:
  * "conventional" (urqmd v3.3+ / smash): full rows with decay channels;
    antibaryon entries are generated automatically for baryon > 0.
  * "smash box": name/mass/width/parity + up to 4 MC IDs per line; all other
    properties are decoded from the PDG Monte-Carlo ID.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

MAX_DECAY_PART = 5  # reference iS3D.h:23


@dataclasses.dataclass
class DecayChannel:
    n_daughters: int
    branch_ratio: float
    daughters: tuple[int, ...]  # MC IDs, zero-padded to MAX_DECAY_PART


@dataclasses.dataclass
class Species:
    mc_id: int
    name: str
    mass: float        # GeV
    width: float       # GeV
    gspin: int         # spin degeneracy
    baryon: int
    strange: int
    charm: int
    bottom: int
    gisospin: int
    charge: int
    sign: int          # quantum statistics: +1 fermion, -1 boson
    stable: int
    decays: list[DecayChannel] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SpeciesTable:
    """Struct-of-arrays view over the HRG composition.

    Mirrors the data the reference flattens in EmissionFunction.cpp:1008-1036
    (Mass/Sign/Degeneracy/Baryon/MCID per species), plus the per-species
    densities at the surface-averaged (T, muB) that
    physics.deltaf.compute_particle_densities caches for the sampler's fast
    mode and the yield estimate (None until it runs).
    """

    species: list[Species]
    mc_id: np.ndarray       # (N,) int64
    mass: np.ndarray        # (N,) f64, GeV
    gspin: np.ndarray       # (N,) f64
    sign: np.ndarray        # (N,) f64
    baryon: np.ndarray      # (N,) f64
    equilibrium_density: np.ndarray | None = None   # (N,) fm^-3
    bulk_density: np.ndarray | None = None          # d n / d bulkPi
    diff_density: np.ndarray | None = None          # d n / d (V.dsigma)

    def __len__(self) -> int:
        return len(self.species)

    @classmethod
    def from_species(cls, species: list[Species]) -> "SpeciesTable":
        return cls(
            species=species,
            mc_id=np.array([s.mc_id for s in species], dtype=np.int64),
            mass=np.array([s.mass for s in species], dtype=np.float64),
            gspin=np.array([float(s.gspin) for s in species], dtype=np.float64),
            sign=np.array([float(s.sign) for s in species], dtype=np.float64),
            baryon=np.array([float(s.baryon) for s in species], dtype=np.float64),
        )

    def index_of_mcid(self, mcid: int) -> int:
        hits = np.nonzero(self.mc_id == mcid)[0]
        if len(hits) == 0:
            raise KeyError(f"MC ID {mcid} not in species table")
        return int(hits[0])

    def chosen_indices(self, chosen_mcids,
                       group_by_mass: bool = False) -> np.ndarray:
        """Map chosen-particle MC IDs to table indices, preserving file order.

        With group_by_mass, stable-sort by mass (the reference's bubble sort,
        EmissionFunction.cpp:375-390).
        """
        idx = [self.index_of_mcid(int(m)) for m in chosen_mcids]
        if group_by_mass:
            idx = sorted(idx, key=lambda i: self.mass[i])
        return np.array(idx, dtype=np.int64)

    def group_species(self, indices: np.ndarray, tolerance: float,
                      key_baryon: bool):
        """Group species whose Cooper-Frye integrands are equal up to the
        (linear) degeneracy factor: the same quantum-statistics sign, the
        same baryon number (when chemistry is on), and masses within
        ``tolerance`` of the group's representative.  One spectra
        evaluation per group then serves every member, rescaled by
        degeneracy (group_particles; the reference reads
        particle_diff_tolerance and mass-sorts, EmissionFunction.cpp:
        375-390, but computes every species).

        Returns (rep_positions, group_of): positions into ``indices`` of
        the group representatives, and for every entry of ``indices`` the
        index of its group in rep_positions.
        """
        indices = np.asarray(indices)
        mass = self.mass[indices]
        sign = self.sign[indices]
        baryon = self.baryon[indices] if key_baryon else np.zeros(len(indices))
        order = np.argsort(mass, kind="stable")

        rep_positions: list[int] = []
        group_of = np.empty(len(indices), dtype=np.int64)
        # (sign, baryon) -> index into rep_positions of the open group
        open_group: dict[tuple, int] = {}
        for pos in order:
            key = (float(sign[pos]), float(baryon[pos]))
            g = open_group.get(key)
            if g is None or \
                    not abs(mass[pos] - mass[rep_positions[g]]) < tolerance:
                rep_positions.append(int(pos))
                g = len(rep_positions) - 1
                open_group[key] = g
            group_of[pos] = g
        return np.array(rep_positions, dtype=np.int64), group_of


# ----------------------------------------------------------------------
# MC ID decoding (smash-box format), readindata.cpp:734-957
# ----------------------------------------------------------------------

def decode_mcid(mcid: int) -> dict:
    """Decode hadron properties from a PDG Monte-Carlo ID.

    Returns gspin, baryon, sign, has_antiparticle (reference read_mcid).
    """
    if mcid < 0:
        raise ValueError("decode_mcid expects particle (not antiparticle) IDs")

    digits = [0] * 10
    x = abs(mcid)
    for i in range(10):
        digits[i] = x % 10
        x //= 10

    nJ = digits[0] + digits[7]  # n8 adds to nJ if spin > 9 (readindata.cpp:777)
    nq3 = digits[1]
    nq2 = digits[2]
    nq1 = digits[3]

    is_deuteron = mcid == 1000010020
    is_hadron = (not is_deuteron) and nq3 != 0 and nq2 != 0
    is_meson = is_hadron and nq1 == 0
    is_baryon_ = is_hadron and nq1 != 0

    if is_deuteron:
        gspin, baryon, sign = 3, 2, -1
        has_anti = True
    elif is_hadron:
        gspin = nJ if nJ > 0 else 1  # nJ==0 special cases (K0L/K0S) -> spin 0
        baryon = 1 if is_baryon_ else 0
        sign = 1 if is_baryon_ else -1
        has_anti = (baryon != 0) or (nq2 != nq3)
    else:
        raise ValueError(f"MC ID {mcid} is not a hadron or deuteron")

    return {
        "gspin": gspin,
        "baryon": baryon,
        "sign": sign,
        "has_antiparticle": has_anti,
        "is_meson": is_meson,
        "is_baryon": is_baryon_,
    }


# ----------------------------------------------------------------------
# conventional format (urqmd / smash), readindata.cpp:973-1095
# ----------------------------------------------------------------------

def _is_self_conjugate(p: Species) -> bool:
    return p.baryon == 0 and p.charge == 0 and p.strange == 0


def read_pdg_conventional(path: str | Path) -> list[Species]:
    tokens = Path(path).read_text().split()
    pos = 0
    species: list[Species] = []
    by_mcid: dict[int, Species] = {}

    def take(n: int):
        nonlocal pos
        t = tokens[pos:pos + n]
        pos += n
        return t

    while pos < len(tokens):
        if len(tokens) - pos < 12:
            break  # trailing junk / blank eof
        (mc_id, name, mass, width, gspin, baryon, strange, charm, bottom,
         gisospin, charge, ndecays) = take(12)
        p = Species(
            mc_id=int(mc_id), name=name, mass=float(mass), width=float(width),
            gspin=int(gspin), baryon=int(baryon), strange=int(strange),
            charm=int(charm), bottom=int(bottom), gisospin=int(gisospin),
            charge=int(charge), sign=0, stable=0,
        )
        for _ in range(int(ndecays)):
            (_dummy, npart, br, d1, d2, d3, d4, d5) = take(8)
            p.decays.append(DecayChannel(
                n_daughters=int(npart), branch_ratio=float(br),
                daughters=(int(d1), int(d2), int(d3), int(d4), int(d5)),
            ))
        p.stable = 1 if (p.decays and p.decays[0].n_daughters == 1) else 0
        species.append(p)
        by_mcid[p.mc_id] = p

        if p.baryon > 0:
            # auto-generate the antibaryon (readindata.cpp:1014-1060)
            anti = Species(
                mc_id=-p.mc_id, name=f"Anti-baryon-{p.name}", mass=p.mass,
                width=p.width, gspin=p.gspin, baryon=-p.baryon,
                strange=-p.strange, charm=-p.charm, bottom=-p.bottom,
                gisospin=p.gisospin, charge=-p.charge, sign=0, stable=p.stable,
            )
            for ch in p.decays:
                daughters = []
                for d in ch.daughters:
                    if d == 0:
                        daughters.append(0)
                    else:
                        dp = by_mcid.get(d)
                        if dp is not None and _is_self_conjugate(dp):
                            daughters.append(d)
                        else:
                            daughters.append(-d)
                anti.decays.append(DecayChannel(ch.n_daughters, ch.branch_ratio,
                                                tuple(daughters)))
            species.append(anti)
            by_mcid[anti.mc_id] = anti

    # quantum statistics sign: baryon even -> boson, odd -> fermion
    # (readindata.cpp:1068-1069; makes the deuteron a boson)
    for p in species:
        p.sign = -1 if (p.baryon % 2 == 0) else 1
    return species


# ----------------------------------------------------------------------
# smash box format, readindata.cpp:1098-1214
# ----------------------------------------------------------------------

def read_pdg_smash_box(path: str | Path) -> list[Species]:
    species: list[Species] = []
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # strip trailing comments
        line = line.split("#", 1)[0]
        parts = line.split()
        if len(parts) < 5:
            continue
        name, mass, width, _parity = parts[0], float(parts[1]), float(parts[2]), parts[3]
        mcids = [int(t) for t in parts[4:8]]
        for mcid in mcids:
            if mcid == 0:
                continue
            info = decode_mcid(mcid)
            base = Species(
                mc_id=mcid, name=name, mass=mass, width=width,
                gspin=info["gspin"], baryon=info["baryon"], strange=0,
                charm=0, bottom=0, gisospin=0, charge=0,
                sign=info["sign"], stable=0,
            )
            species.append(base)
            if info["has_antiparticle"]:
                species.append(dataclasses.replace(
                    base, mc_id=-mcid, name=f"Anti-{name}",
                    baryon=-info["baryon"],
                ))
    return species


_HRG_FILES = {1: "pdg-urqmd_v3.3+.dat", 2: "pdg_smash.dat", 3: "pdg_box.dat"}


def read_pdg(hrg_eos: int, pdg_dir: str | Path = "PDG") -> SpeciesTable:
    """Read the HRG composition selected by hrg_eos (1=urqmd, 2=smash, 3=box)."""
    path = Path(pdg_dir) / _HRG_FILES[hrg_eos]
    if hrg_eos in (1, 2):
        species = read_pdg_conventional(path)
    else:
        species = read_pdg_smash_box(path)
    return SpeciesTable.from_species(species)
