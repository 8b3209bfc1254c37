"""Typed run configuration.

Replaces the reference's flat string->double ParameterReader
(src/cpp/ParameterReader.cpp:38-142) with a typed dataclass.  The same
``name = value  # comment`` file format is accepted by :meth:`Config.from_file`
so existing iS3D_parameters.dat files work unmodified, and every parameter of
the reference (iS3D_parameters.dat) is represented with the same default.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass(frozen=True, eq=True)
class Config:
    # what to compute (iS3D_parameters.dat: operation)
    #   0 = spacetime distributions dN/dX
    #   1 = smooth momentum spectra dN/pTdpTdphidy
    #   2 = sampled particle list (or sampler-test histograms)
    operation: int = 1

    # surface file format (readindata.cpp:149-164)
    #   0 = legacy GPU VH, 1 = CPU VH / CPU VAH, 2/3 = legacy VAH,
    #   4 = MUSIC (old), 5 = CPU VH + thermal vorticity,
    #   6 = MUSIC (public), 7 = HIC-EventGen
    mode: int = 1

    # PDG file (readindata.cpp:1217-1252): 1 = urqmd v3.3+, 2 = smash, 3 = smash box
    hrg_eos: int = 3

    # 2 = boost-invariant 2+1d, 3 = 3+1d
    dimension: int = 2

    # delta-f correction (EmissionFunction.cpp:161-187)
    #   1 = Grad 14-moment, 2 = RTA Chapman-Enskog,
    #   3 = PTM modified equilibrium, 4 = PTB modified equilibrium,
    #   5 = PTM modified anisotropic (famod)
    df_mode: int = 4

    include_baryon: int = 0
    include_bulk_deltaf: int = 1
    include_shear_deltaf: int = 1
    include_baryondiff_deltaf: int = 0

    regulate_deltaf: int = 0
    outflow: int = 0

    deta_min: float = 1.0e-5   # min detA for feqmod breakdown
    mass_pion0: float = 0.138  # lightest pion mass (GeV) for breakdown test

    # legacy GPU launch geometry of the reference (accepted, unused)
    threads_per_block: int = 128
    chunk_size: int = 128

    # sampler
    oversample: int = 1
    fast: int = 1
    y_cut: float = 5.0
    min_num_hadrons: float = 1.0e7
    max_num_samples: float = 1.0e3
    sampler_seed: int = 1
    test_sampler: int = 1

    # sampler-test binning
    pT_min: float = 0.0
    pT_max: float = 3.0
    pT_bins: int = 100
    y_bins: int = 100
    phip_bins: int = 100
    eta_cut: float = 7.0
    eta_bins: int = 140
    tau_min: float = 0.0
    tau_max: float = 12.0
    tau_bins: int = 120
    r_min: float = 0.0
    r_max: float = 12.0
    r_bins: int = 60

    group_particles: int = 0
    particle_diff_tolerance: float = 0.01

    do_resonance_decays: int = 0
    lightest_particle: int = 111

    # --- framework extensions (not in the reference), same names and
    # defaults as is3d2_tpu/config.py ---
    # compute dtype of the Cooper-Frye engines: "f64" (the torch f64
    # engines), "f32" (plain f32) or "f32c" (compensated f32: the exp
    # argument in split-exact arithmetic, <=1e-6 of f64).  df 1/2 run
    # kernel B1 for both f32 and f32c, as the JAX package does on an
    # accelerator; df 3/4 run kernel B3, df 5 its famod mode
    compute_dtype: str = "f64"
    # the JAX package's Pallas switch: -1 = auto, 1 = on, 0 = off.  With
    # f32/f32c every value runs the hand-written kernels (0 selects the JAX
    # package's XLA fast paths, for which the port's kernels stand in;
    # validate_slice).  With f64, 1 selects kernel B2 (plain f32) for df
    # 1/2 and kernel B3 for df 3-5 in 2+1d
    use_pallas: int = -1
    # number of freezeout cells per device block in the CF reduction
    cell_block: int = 4096
    # max envelope hadrons per sampler chunk: an oversampling campaign is
    # split into event chunks so per-hadron device buffers stay bounded
    # (~30 live f32 arrays of this length) regardless of min_num_hadrons
    sampler_chunk_hadrons: float = 8.0e6
    # also write the plain-CSV particle lists (the reference's main path
    # writes only OSCAR, EmissionFunction.cpp:1290; CSV doubles export time)
    write_csv: int = 0
    # multi-device sharding of the engines and the sampler over the local
    # devices (parallel/): -1 = auto (several CUDA devices), 0 = off,
    # 1 = force on (also several CPU devices)
    use_mesh: int = -1
    # mesh shape: devices = (devices/mesh_species_shards) cell shards
    # x mesh_species_shards species shards
    mesh_species_shards: int = 1
    # fold the symmetric 2+1d eta quadrature onto half the nodes when the
    # integrand is exactly even in eta (see spectra_fast.fold_eta_quadrature
    # for the gate): -1 = auto (fold when exact), 0 = off
    eta_fold: int = -1

    # ------------------------------------------------------------------
    _INT_FIELDS = {
        "operation", "mode", "hrg_eos", "dimension", "df_mode",
        "include_baryon", "include_bulk_deltaf", "include_shear_deltaf",
        "include_baryondiff_deltaf", "regulate_deltaf", "outflow",
        "threads_per_block", "chunk_size", "oversample", "fast",
        "sampler_seed", "test_sampler", "pT_bins", "y_bins", "phip_bins",
        "eta_bins", "tau_bins", "r_bins", "group_particles",
        "do_resonance_decays", "lightest_particle", "cell_block",
        "write_csv", "use_mesh", "mesh_species_shards", "eta_fold",
    }

    @classmethod
    def from_file(cls, path: str | Path) -> "Config":
        """Parse a reference-format parameter file (``name = value # comment``)."""
        values: dict[str, object] = {}
        known = {f.name for f in dataclasses.fields(cls)}
        for raw in Path(path).read_text().splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            name, _, val = line.partition("=")
            name = name.strip()
            val = val.strip()
            if name not in known:
                continue  # unknown keys are ignored (forward compatible)
            if name in cls._INT_FIELDS:
                values[name] = int(float(val))
            elif name in ("compute_dtype",):
                values[name] = val
            elif name in ("use_pallas",):
                # accepts the legacy booleans and the tri-state ints
                values[name] = (0 if val in ("0", "false", "False")
                                else 1 if val in ("true", "True")
                                else int(float(val)))
            else:
                values[name] = float(val)
        return cls(**values)  # type: ignore[arg-type]

    def validate(self) -> None:
        if self.operation not in (0, 1, 2):
            raise ValueError("operation must be 0, 1 or 2")
        if self.mode not in (0, 1, 2, 3, 4, 5, 6, 7):
            raise ValueError("mode must be one of 0-7")
        if self.hrg_eos not in (1, 2, 3):
            raise ValueError("hrg_eos must be 1, 2 or 3")
        if self.dimension not in (2, 3):
            raise ValueError("dimension must be 2 or 3")
        if self.df_mode not in (1, 2, 3, 4, 5):
            raise ValueError("df_mode must be in 1..5")
        if self.compute_dtype not in ("f32", "f64", "f32c"):
            raise ValueError("compute_dtype must be 'f32', 'f64' or 'f32c'")

    def validate_slice(self) -> None:
        """Reject what the JAX package rejects: df 4 with baryons, and df 5
        in operation 0.

        Every other configuration runs, in 2+1d and 3+1d, on one device or
        (``use_mesh``) sharded over the local devices (parallel/).
        ``use_pallas`` selects between a Pallas kernel and an XLA program
        in the JAX package, a choice that exists because a TPU has two
        compilers; the port has one implementation of each sum.  So with
        f32/f32c, use_pallas 0 runs the kernels that -1 and 1 run (B1 for
        df 1/2, B3 for df 3/4, B3's famod mode for df 5; their 3+1d modes
        on a 3+1d surface; on the CPU their plain versions).  With f64 it
        selects B2 (df 1/2) or B3 (df 3-5) in 2+1d with use_pallas 1 only,
        as the JAX package does; operation 0 and the sampler ignore it."""
        self.validate()
        if self.df_mode == 4 and self.include_baryon:
            # as the JAX package's DeltafData.evaluate raises
            raise ValueError("PTB (Jonah) df does not support nonzero muB")
        if self.operation == 0 and self.df_mode == 5:
            # as the JAX package's compute_dN_dX raises
            raise ValueError("no spacetime distribution routine for famod "
                             "(matches the reference, "
                             "EmissionFunction.cpp:1184-1189)")
