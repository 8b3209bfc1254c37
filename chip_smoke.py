"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises; nothing is caught):
  1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
     fails without a CUDA device;
  2. build the four kernels with nvcc (sm_90a), one nvcc per source,
     started together, and print ptxas' registers, static shared memory and
     spills of each (the most over a source's instantiations, and the
     instantiation its main path launches); for P1's two instantiations,
     the special-function (MUFU) and conversion (F2F) instructions of its
     eta loop per evaluation and of its per-cell step, from cuobjdump's
     SASS (phase 22's sfu_floor_ms reads the MUFU count); the same counts
     by pipe for B1's main-path instantiation and for its 3+1d mode's
     (the cell loop per evaluation; phases 6 and 24's fp32_issue_floor_ms
     read the FP32 count), and for B3's 3+1d clean kernel with its
     registers and spills; and for P1's 3+1d mode (its cell loop per
     evaluation, which phase 36's sfu_floor_ms and fp32_issue_floor_ms
     read).  The SASS is parsed in a process of its own while phases 3-5
     run, and printed before phase 6 (2b);
  3. kernel B1 (compensated, df 1/2) vs its plain torch version and the
     port's f64 engine at a reduced shape (2048 cells, 16 species, 51 pT x
     48 phi, 24 eta) for df 1 and df 2 with the clip/outflow/diffusion
     variants, and without shear delta-f (include_shear_deltaf 0: the
     kernel's kShear = false instantiations): <= 1e-6 relative on bins
     >= 1e-4 of each species' peak (is3d2_tpu_torch/tools/kernel_check);
     a ragged case against the
     plain version (kernel_check.RAGGED: rows of 7 phi under a register
     tile of 4, 105 momenta, 1000 cells); and df 1 on an eta table of 80
     nodes, not folded (kernel_check.ETA_NODES): three launches of at most
     32 nodes, held to the plain version and the f64 engine;
  4. kernel B3 (feqmod, df 3/4) vs its plain version (<= 1e-5) and the f64
     feqmod engine (<= 1e-4) at the same shape, on a surface with large
     viscous corrections (shear 0.2, bulk 0.1 of E + P) so that cells break
     down: df 3, df 4, df 3 with outflow + regulation, df 4 with
     regulation; the famod mode (df 5) vs its plain version (<= 1e-5) and
     the f64 famod engine (<= 1e-4) on the famod prep of an EOS-consistent
     surface (shear 0.1, bulk 0.05; kernel_check.FAMOD_SURFACE); the ragged
     case in df 4; and df 4 on the 80-node table;
  5. the df-1 main path at full size through the CLI: 1e5 cells, the full
     ~370-species list, 51 pT x 48 phi x 24 eta, f32c.  B1's launch count
     must move, the spectra must be finite and non-negative and dN/dy must
     order pi+ > K+ > p;
  6. B1 on the main path's own operands (102,400 padded cells x 12 eta x
     ~9.1e5 momenta, not a multiple of the block) timed at full size, and
     held to its plain version (<= 1e-6) on the first 16,384 cells at the
     full M, both timed there; two launches at full size must give equal
     bits; fp32_issue_floor_ms (its FP32 instructions an evaluation from
     phase 2 over 128 lanes x 132 SMs x the card's clocks.max.sm);
  7. the df-4 main path at full size through the CLI: as phase 5 with df 4,
     f32, shear 0.2 and bulk 0.1: B3's launch count must move and cells
     must break down;
  8. B3 on the df-4 main path's operands, timed at full size, and held to
     its plain version (<= 1e-5) on the first 8,192 cells at the full S and
     M, both timed there; two launches at full size must give equal bits;
  9. kernel B2 (plain f32, df 1/2) vs its plain version (<= 1e-5) and the
     f64 engine (<= 2e-5) at phase 3's shape, over the cases of
     kernel_check.F32_CASES (compute_dtype f64, use_pallas 1); the ragged
     case in df 2; and df 2 on the 80-node table;
 10. the use_pallas = 1 main path at full size through the CLI: as phase 5
     with df 2 and compute_dtype f64.  B2's launch count must move and B1's
     and B3's must stay at 0;
 11. B2 on phase 10's operands, timed at full size, and held to its plain
     version (<= 1e-5) on the first 8,192 cells at the full M, both timed
     there; two launches at full size must give equal bits;
 12. the operation-2 histogram main path at full size through the CLI:
     phase 5's workdir (1e5 cells, all species, df 1) with test_sampler 1,
     fast 1, min_num_hadrons 1e7, max_num_samples 1000 and a fixed
     sampler_seed.  No kernel may launch; the kept yield must lie within
     0.05 Ntot + 5 sqrt(Ntot / n_events) of the estimate per event, drawn /
     kept below 2.7, no lane dropped, and the sampled dN/dy of pi+, K+ and
     p within 5 sigma + 1% of phase 5's op-1 dN_dy files.  Then the six
     phase functions on one full chunk, each timed with CUDA events, the
     chunk run twice with one seed (equal bits), and torch.poisson held to
     its mean and variance at the chunk's largest Poisson mean;
 13. the operation-2 OSCAR path at full size through the CLI: phase 7's
     df-4 workdir with test_sampler 0 and min_num_hadrons 1e7: one file per
     event with the OSCAR header and 11 columns, rows summing to the kept
     count, the yield bound of phase 12; it prints the write, transfer and
     overlapped seconds;
 14. the df-5 main path at full size through the CLI: 1e5 cells of an
     EOS-consistent surface (shear 0.1, bulk 0.05), all species, 51 x 48 x
     24, f32: the famod prep (the VAH reconstruction in f64 on the card)
     and B3's famod mode.  B3's launch count must move, B1's and B2's stay
     at 0, cells must break down; it prints the breakdown, pl < 0 and
     reconstruction-failure counts, the Newton iterations and the stage
     seconds with the famod prep split out;
 15. B3's famod mode on phase 14's operands, timed at full size, held to its
     plain version (<= 1e-5) on the first 8,192 cells at the full S and M;
     two launches at full size must give equal bits;
 16. operation 2 with df 5 on phase 14's workdir: test histograms, 1e7
     hadrons, a fixed seed, phase 12's bounds (yield, no dropped lane, equal
     bits from one seed, dN/dy of pi+, K+ and p within 5 sigma + 1% of an
     op-1 run of phase 14's surface on tables that resolve it: 96 eta nodes,
     pT to 6 GeV) and no kernel launch in the sampler;
 17. the grouped main path through the CLI: phase 5's surface written in
     mode 6 (public MUSIC), df 1, f32c, group_particles 1 (371 species ->
     94 representatives at tolerance 0.01).  Only B1 may launch; it prints
     M and B1's time on the representatives, and holds the grouped spectra
     to an ungrouped run of the same surface: <= 1e-12 on the species that
     share (mass, sign, baryon) with their representative, <= GROUP_BAR
     (the grouping's own error, measured with the JAX package) on all;
 18. operation 0 (dN/dX), df 1, f32c, on phase 5's surface through the
     CLI: only B1's per-cell mode may launch; the files finite, the tau
     bins summed back to phase 5's dN/dy of pi+, K+ and p (<= 1e-5); the
     per-cell route (spacetime.comp_cell_bins) timed whole and its kernel
     alone at full size (two launches, equal bits) against its bound, and
     the kernel held to its plain version on the first 8,192 of its cells
     (<= 1e-6 of each cell's sum of |terms|); at 2,048 cells the route
     against its plain version, the per-bin route (<= 1e-12) and the f64
     engine (<= 1e-6), twice for the same bits.  Then the per-bin route
     that the meshed twin keeps: B1 once per non-empty (tau, r, phi_s) bin,
     the launches timed one by one by CUDA events and summed, B1 on the
     fullest bin's cells against its plain version (<= 1e-6), and at 2,048
     cells that route against its plain version and the f64 engine;
 19. operation 0, df 4, f32, on a mode-6 surface with dsigma_eta / tau in
     +-0.05 (not folded: 24 eta nodes), shear 0.2, bulk 0.1: B3 in its
     dan-weighted variant once per bin, timed as in 18; B3 on the fullest
     bin that holds a breakdown cell against its plain version (<= 1e-5);
     at 2,048 cells (df 4, and df 3 with outflow, where the convention
     decides the number) the route against its plain version (<= 1e-5) and
     the f64 engine (<= 1e-4);
 20. kernel P1 (spin polarization, f32), both instantiations (eta-folded,
     and general with eta_fold = 0 or with un != 0), vs its plain version
     (<= 1e-5 on both metrics) and the f64 polarization engine (never
     folded) at the JAX package's bars for its f32 route (Snorm <= 2e-5
     relative on bins >= 1e-6 of its max; P^mu = S^mu / Snorm within 1e-5
     of max |P| where Snorm >= 1e-3 of its max) at phase 3's shape (2,048
     cells) on a surface with thermal vorticity; on the 80-node table
     (40 folded nodes in two launches, 80 in three); the ragged case;
 21. the mode-5 main path at full size through the CLI: phase 5's surface
     with thermal vorticity, written in mode 5, df 1, f32c.  B1 (the
     spectra) and P1 (the polarization) must both launch and no other
     kernel, P1 once, folded, on 12 nodes; the four files St, Sx, Sy, Sn
     hold S x 48 x 51 = 908,208 finite rows each; it prints the stage
     seconds (polarization included);
 22. P1 on phase 21's operands (the 100,000 real cells x 12 folded eta x
     908,208 momenta; and the general instantiation on all 24 nodes),
     timed at full size between two samples of the SM clock: evaluations/s,
     share of the bound and sfu_floor_ms (the MUFU operations over 16
     lanes x 132 SMs x the card's clocks.max.sm); every sum finite and
     Snorm > 0; two launches give equal bits; the folded and the general
     sums within the JAX bars of each other; each held to its plain
     version (<= 1e-5 on both metrics) on the first 4,096 cells at the
     full M, both timed there;
 23. kernel B1's 3+1d mode vs its plain version and the f64 engine at 2,048
     cells of a 3+1d surface (make_surface(dimension=3): each cell's eta in
     [-2, 2]), 16 species, 51 pT x 48 phi x 21 y (|y| <= 5): f32c over
     kernel_check.CASES (df 1, df 2, clip + outflow, baryons + diffusion)
     and f32 (df 1, df 2: the same kernel, the same bits): <= 1e-6
     relative against the plain version on bins >= 1e-4 of each species'
     peak; against the f64 engine the JAX package's 3+1d budget, <= 1e-6
     on bins >= 1e-4 of the largest bin of all species and <= 2.5e-7 of
     each species' peak on every bin (kernel_check.Case3dResult; the error
     relative to each species' own peak is printed); and the ragged case
     on 3, 5 and 1 rapidities (kernel_check.RAGGED_Y: y counts the y tile
     does not divide, and fewer than one tile);
 24. the 3+1d df-1 main path at full width through the CLI: 1e5 cells of a
     3+1d surface, all species, 51 x 48 x 21 y, f32c (M = 19,072,368).
     Only B1's 3+1d mode may launch; the files hold S x 51 x 48 x 21 rows,
     finite, dN/dy pi+ > K+ > p > 0 at every |y| <= 3 and pi+ > 0 at
     every y.  Then the 3+1d mode on that
     path's operands (the live cells x M) timed at full size between two
     samples of the SM clock, launched twice for equal bits, and held to
     its plain version (<= 1e-6) on the first 1,024 live cells at the full
     M, both timed there; evaluations/s, share of the bound and
     fp32_issue_floor_ms (as phase 6's);
 25. operation 0 on phase 24's surface cut to its first OP0_3D_CELLS
     cells (all species, the full 51 x 48 x 21 grid): in 3+1d every dtype
     runs the f64 engine (no kernel may launch), one cell per block; its
     tau bins summed back to the y-summed dN/dy of B1's 3+1d mode on the
     same cells (<= 1e-5);
 26. operation 2 on phase 24's workdir: test histograms, min_num_hadrons
     1e7, a fixed seed, phase 12's bounds on the yield and the lanes, no
     kernel launch; the sampled dN/dy of pi+ and K+ in every bin at
     |y| < 1 within 5 sigma + 3 % of phase 24's dN/dy (the JAX package's
     3+1d closure bar; p is printed, ROADMAP C9); then OSCAR files with
     df 2 at min_num_hadrons 1e6, checked as phase 13's;
 27. the multi-surface ensemble's spectra (core/ensemble.py) on the JAX
     package's ensemble record (scripts/northstar.py:180-191): 64 surfaces
     make_surface(4096, seed=1000 + i, shear 0.03, bulk 0.015), phase 5's
     species and tables, df 1, f32c, cell_block 4096, surface_chunk 16.
     One surface's route is queued under torch's sync debug mode "error"
     (nothing synchronizes); then, in turns, the pipeline, the loop of 64
     compute_spectra calls a user would otherwise write, the loop, the
     pipeline: each with its wall, the kernel ms summed over its 64 B1
     launches (CUDA events around each launch), the busy share (kernel /
     wall) and the device's gap between one launch's end and the next one's
     start.  The first pipeline run must launch B1 64 times and nothing
     else; every surface equals its single run bit for bit, the two
     pipeline runs equal each other, and surface_chunk None on the first 8
     surfaces gives the same bits;
 28. the ensemble sampler on phase 27's surfaces: df 1, fast, y_cut 3, 10
     events a surface into the test histograms, seed 5; no kernel may
     launch; surface_chunk 16 and None equal on all 64 surfaces, and
     surfaces 0 and 63 equal to sample_particles + ChunkBinner with
     surface_seed(5, i); kept, drawn and seconds printed;
 29. the ensemble on the other routes, every surface bit-equal to its
     single run and one launch of the route's kernel a surface: df 4 f32
     (B3; 8 surfaces, shear 0.2, bulk 0.1), df 5 f32 (B3's famod mode and
     the VAH reconstruction; 4 of phase 27's surfaces made EOS-consistent),
     df 2 f64 with use_pallas 1 (B2; 4 surfaces), 3+1d df 1 f32c (B1's
     3+1d mode; 4 surfaces make_surface(4096, dimension=3), phase 24's
     tables, 21 y), 3+1d df 4 f32 (B3's 3+1d mode; 4 surfaces, shear
     0.2, bulk 0.1) and 3+1d df 5 f32 (its famod instantiation; 4
     EOS-consistent surfaces); then OSCAR particle lists, df 1, 8 surfaces
     x 10 events: one file an event, rows = kept = rows_written;
 30. kernel B3's 3+1d mode vs its plain version (<= 1e-5) and the f64
     feqmod / famod engines (<= 1e-4 of each species' peak bins) at 2048
     cells of 3+1d surfaces (shear 0.2, bulk 0.1; famod EOS-consistent),
     16 species, 51 x 48 x 21 y, over kernel_check.FEQMOD_3D_CASES (df 3,
     df 4, outflow, regulation, famod), a narrow-window case (cells with
     detA < 0.01 moved within detA of a y node; it fails without a (cell,
     y) pair in the window) and the ragged case on 3, 5 and 1 rapidities;
     every case needs breakdown cells.  The mode's route is split by cell
     (the clean kernel on the cells that never take the linearised branch,
     the mixed kernel on the others): on each case's operands it is held to
     the mixed kernel on every cell (fk.launch_3d, the one kernel it
     replaced) within SPLIT_TOL = 1e-10, and equals it bit for bit on the
     clean cells alone at one split;
 31. the 3+1d df-4 main path at full width through the CLI: phase 24's
     size (1e5 cells, 99,753 live, 371 species, 51 x 48 x 21 y), f32,
     shear 0.2, bulk 0.1 (1.903e12 evaluations); only B3's 3+1d mode may
     launch, once; the files checked as phase 24's;
 32. B3's 3+1d mode on phase 31's operands timed by CUDA events between
     samples of the SM clock, launched twice for equal bits, and held to
     its plain version (<= 1e-5) on the first 1,024 live cells at the full
     M (breakdown cells among them), both timed there; evaluations/s and
     the share of the bound (BOUND_OPS_PER_EVALUATION, the linearised
     branch counted on the breakdown cells and the window's rows); the
     clean and touched cell counts, the route against the mixed kernel on
     every cell (<= 1e-10) and on the clean cells alone at one split
     (equal bits), and the clean kernel on its cells, the mixed kernel on
     the touched ones and the mixed kernel on every cell, each timed by
     CUDA events, with both geometries;
 33. the 3+1d df-5 main path through the CLI on an EOS-consistent surface
     of phase 31's size: the VAH reconstruction, then B3's 3+1d famod
     instantiation, which alone may launch, once; then that instantiation
     on the path's operands, timed and held to the mixed kernel as phase
     32's;
 34. operation 0 in 3+1d, df 4, on phase 31's surface cut to its first
     OP0_3D_DF4_CELLS cells (a cell block of 512, so no padding cell is
     evaluated) through the f64 engine (no kernel may launch; the engine
     takes ~17 ms a cell), its
     tau bins summed back to B3's 3+1d dN/dy summed over y (<= 1e-4); then
     operation 2 with df 4 and df 5 on the workdirs of phases 31 and 33 into
     histograms (1e6 hadrons), each with phase 26's closure against its own
     op-1 dN/dy files;
 35. kernel P1's 3+1d mode (polarization_f32_3d_kernel: a thread owns 4
     phi x 3 y of one (species, pT) group; the exponential factored into a
     (cell, y) and a (cell, phi) factor; the terms of each 256-cell run
     summed in f32, the runs in f64) vs its plain version (<= 1e-5 on both
     metrics) and the f64 polarization engine at the JAX package's bars
     (Snorm <= 2e-5, P <= 1e-5 of max |P|) at phase 23's 2,048 cells with
     thermal vorticity, 16 species, 51 x 48 x 21 y; on a surface whose
     even cells sit within 1e-4 of a y node (kernel_check.
     near_cancellation_surface: the pure pn spin terms take mT sinh(y -
     eta) there); on a cold, fast-flowing surface (kernel_check.
     fast_flow_surface: |u_perp| ~ 3, T = 0.08 GeV, where the factors
     would be inf and 0 without their shift; against f64 at
     kernel_check.FAST_FLOW_TOL); the ragged case on 3, 5 and 1
     rapidities;
 36. the 3+1d mode-5 main path at full width through the CLI: phase 24's
     surface (1e5 cells, 99,753 live, 100,000 real) plus vorticity in
     +-0.05 (drawn last: the other fields keep their bits), 371 species,
     51 x 48 x 21 y, df 1, f32c.  B1's 3+1d mode (the spectra) and P1's
     3+1d mode (the polarization) must both launch, once each, and no
     other kernel; P1 on the 100,000 real cells x 19,072,368 momenta
     (1.907e12 evaluations); the four files St, Sx, Sy, Sn hold
     19,072,368 finite rows each.  Then P1's 3+1d mode on that path's
     operands timed between samples of the SM clock, twice for equal bits
     and finite sums; evaluations/s, the share of the bound, sfu_floor_ms,
     fp32_issue_floor_ms and issue_floor_ms (all its instructions over
     the card's 128 issue lanes an SM; phase 2's SASS counts); against its
     plain
     version on the first 1,024 real cells at the full M, both timed; and
     the kernel against the f64 engine (~5 ms a cell at full width) on
     the surface cut to its first 2,048 cells, at the JAX bars;
 37. the sweep tool (is3d2_tpu_torch.tools.sweep.run_sweep) at full width
     on a copy of phase 5's workdir (the sweep overwrites the workdir's
     results): grad, ce, ptm, ptb x shear_bulk (SWEEP_CORRECTIONS), 4 runs
     of 1e5 cells, 371 species, 51 x 48 x 24, f32c; then famod x none,
     shear on a copy of phase 14's.  The launch counts, set to 0 before
     each sweep: 2 of B1 and 2 of B3, then 2 of B3 (its famod mode), and
     no other kernel; every archive with its main path's file names (phase
     5's, 14's), those of every 8th species and of pi+, K+ and p of their
     shapes, finite and non-negative; grad/shear_bulk (phase 5's configuration) equal to
     phase 5's files byte for byte; each run's stage seconds and the
     sweeps' walls printed;
 38. use_pallas = 0 with f32/f32c (the JAX package's XLA fast paths, for
     which the kernels stand in): a copy of phase 5's workdir with
     use_pallas 0 through the CLI, B1 alone launching, its files phase 5's
     bytes; df 3 f32, df 4 f32 and f32c, df 5 f32 on 2,048-cell surfaces
     (shear 0.2, bulk 0.1; df 5 kernel_check.famod_surface) with phase
     3's workdir: each launches B3 (df 5 its famod mode) once, equals its
     use_pallas = -1 run bit for bit and meets the f64 engine at 1e-4;
 39. the oversampling campaign (is3d2_tpu_torch.tools.oversample) on
     phase 12's workdir: 4 batches of a quarter of phase 12's events
     (~2.5e6 hadrons each) with seeds sampler_seed + 1000 b into OSCAR
     files, no kernel launched; each batch's yield per event within 0.05
     Ntot + 5 sqrt(Ntot / n) of the estimate, the batches' first events
     different, batch 0's pi+, K+ and p dN/dy (its OSCAR rows at |y| <
     y_cut) within 5 sigma + 1 % of phase 5's files; then
     tools.analysis.compare_sampling_smooth on phase 12's histograms
     against phase 5's spectra (yield ratio within 5 %), and
     compute_observables on a 20-event op-2 run with CSV files (the
     surface cut to its first 5,000 cells), whose identified dN/dy at |y|
     < 0.5 equal the run's own ParticleList counts event by event;
 40. the meshed main path (parallel/, cfg.use_mesh = 1; one card stands
     for four devices, parallel/sharding.local_devices giving
     [cuda:0] * 4): phase 5's workdir through the driver in memory, once
     on one device, then under the meshes (4, 1) and (2, 2)
     (mesh_species_shards 1, 2) and, where torch sees several cards, over
     all of them as (n, 1).  B1 launches once a shard and nothing else;
     the spectra within MESH_TOL = 1e-12 of the single device's on bins
     >= 1e-4 of each species' peak (whole cell blocks keep each cell's
     f32 work: only the f64 order moves); it prints each shard's device,
     cells, species and cell split, the sum of the per-shard CUDA-event
     ms against one device's 2,040.3 ms, and the wall;
 41. the meshed routes at MESH_CELLS = 1,024 cells (cell_block 256) of
     phase 3's workdir and phase 23's 3+1d one, through the driver in
     memory under (4, 1) and (2, 2) against the single-device run, each
     within MESH_TOL (op 0 on each axis' normalized bins, the
     polarization's five sums in units of their max): B3 df 4 (shear 0.2,
     bulk 0.1), B3 famod (EOS-consistent), the f64 engines of df 1 and
     df 4, B1's 3+1d mode, op 0 df 1 (B1) and df 4 (B3) per bin and
     shard, P1 folded and P1's 3+1d mode (mode 5), and 3+1d op 0 (the
     f64 engine) on 256 cells in blocks of 64; each shard launches the
     route's kernel.  Then the two routes the JAX package keeps on one
     device under a mesh: B2 (df 2, f64, use_pallas 1) and B3's 3+1d
     mode (df 4, f32, shear 0.2, bulk 0.1): each launches its kernel
     exactly once, records no shard, and stays within MESH_TOL of its
     run with use_mesh 0;
 42. the meshed op 2 through the driver's meshed branches: phase 12's
     histogram campaign (1e7 kept, in chunks of 3e6 drawn hadrons, in
     memory) against the same campaign on one device: the counts equal,
     the v_n sums within MESH_TOL of their max (CUDA's index_add_ adds
     f64 with atomics); phase 13's OSCAR configuration at 1e6 hadrons in
     chunks of 1.5e5: the event files equal the single device's byte for
     byte; no kernel launches; over [cuda:0] * 4 and, where there are
     several, all cards;
 43. the meshed ensemble: 8 of phase 27's surfaces under a (4, 1) mesh of
     cuda:0 x 4 (core/ensemble.py's surface groups), B1 once a surface,
     every surface bit-equal to its single compute_spectra run; the
     kernel ms summed and the busy share.

Before the card's line, a JSON object {"sampler": {...}} carries phases
12-13's, 16's and 26's numbers, one {"ensemble": {...}} phases 27-29's,
one {"tools": {...}} phases 37-39's, one {"mesh": {...}} phases 40-43's
and one {"phase_seconds": {...}, "total_s": ...} each phase function's
wall and the script's.  The line before the last is a JSON object with each
kernel's measurements (phases 17-18 under B1's "grouped_mode6" and
"operation0", phase 19 under B3's "operation0", each with the launches of
its own path; P1's launches from phase 21, its folded instantiation's
numbers at the top and the general one's under "general", each with its
sfu_floor_ms beside the bound; B1 and B1's 3+1d mode, an entry of its
own from phases 24-25, with fp32_issue_floor_ms beside it; B3's 3+1d
mode, an entry of its own from phases 30-34 (its famod instantiation
under "famod", operations 0 and 2 under "operations"); P1's 3+1d mode, an
entry of its own from phases 35-36; each of B1, B2, B3
and the two 3+1d modes with the launches and times of its ensemble runs in
phases 27 and 29 under "ensemble"; each kernel's runs in phases 40-43 under
"mesh", B2's and B3's 3+1d mode's the one launch of their route under
each mesh),
its bound (the least time the card could take for the same work, from
BOUND_OPS_PER_EVALUATION and the bytes of its operands), library_ms null
(no single PyTorch call computes a Cooper-Frye or polarization sum), and
the register tile
and the cell split that the wrapper launched with at full size.  The bound
counts, per kernel, the fewer of the operations of its plain version
(OPS_PER_EVALUATION) and of the kernel itself
(EXECUTED_OPS_PER_EVALUATION); all three are printed on a line before it.
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import multiprocessing
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MAIN_CELLS = 100_000
KERNELS = ("cooper_frye_comp", "cooper_frye_feqmod", "cooper_frye_f32",
           "polarization_f32")
# kernels that live in another kernel's source (name -> source)
SOURCE_OF = {"cooper_frye_comp_3d": "cooper_frye_comp",
             "cooper_frye_comp_cells": "cooper_frye_comp",
             "cooper_frye_feqmod_3d": "cooper_frye_feqmod",
             "cooper_frye_feqmod_3d_clean": "cooper_frye_feqmod",
             "polarization_f32_3d": "polarization_f32"}
# a kernel's name where it is not "<name>_kernel"
KERNEL_NAME = {"cooper_frye_comp_cells": "cooper_frye_comp_kernel_cells"}
B1_COMPARE_CELLS = 16_384
# phase 18: B1's per-cell mode against its plain version
B1_CELLS_COMPARE_CELLS = 8_192
B2_COMPARE_CELLS = 8_192
B3_COMPARE_CELLS = 8_192
P1_COMPARE_CELLS = 4_096
B1_3D_COMPARE_CELLS = 1_024
B3_3D_COMPARE_CELLS = 1_024
OP0_3D_CELLS = 2_048
P1_3D_COMPARE_CELLS = 1_024
# phase 36's f64 check: the f64 polarization engine takes ~5 ms a cell at
# full width
P1_3D_F64_CELLS = 2_048
# B3's 3+1d route against the mixed kernel on every cell: only the order of
# the f64 additions moves
SPLIT_TOL = 1e-10
# phase 34's op 0 cut, with a cell block of its size (the f64 engines
# evaluate the padding cells too): the f64 feqmod engine takes ~17 ms a
# cell in 3+1d at full width, so phase 25's 2,048 cells would take 35 s of
# the script's time limit
OP0_3D_DF4_CELLS = 512

# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
H100_SMS = 132
# FP32 lanes of one SM: one FP32 instruction a lane and clock at most
FP32_LANES_PER_SM = 128

# Floating-point operations per (cell, eta, m) evaluation at the main paths'
# settings (shear and bulk delta-f; no diffusion, regulation or outflow),
# counted from the plain versions' arithmetic: each elementwise add,
# multiply, divide, exp, sqrt, clamp or f32 -> f64 conversion on a
# (cells, M) tensor counts one, and so does each term of the f64 sum; work
# outside the eta loop counts once per 12 eta nodes (P1's general
# instantiation: 24); per-cell and per-momentum work is left out.  f64
# operations count at the FP32 rate, so the bound stays a lower bound.
# B3's kernel runs one branch per cell, so its two branches count apart;
# P1's two instantiations count apart.
OPS_PER_EVALUATION = {
    "cooper_frye_comp": 70 + 26 / 12,     # df 1
    "cooper_frye_f32": 34 + 12 / 12,      # df 2
    "cooper_frye_feqmod": {"modified": 30 + 9 / 12,    # df 4
                           "breakdown": 43 + 9 / 12,
                           # df 5: the modified branch is df 4's; the
                           # breakdown branch is plain f_eq (E 2, p.dsigma 3,
                           # f_eq 6, value 1, the sum 2; gd, exy and the
                           # per-cell sum 11 outside the loop)
                           "famod_modified": 30 + 9 / 12,
                           "famod_breakdown": 14 + 11 / 12},
    # folded: e_m, d_m 2, the exponent, 2^x, + sign, clamp, 1 / x 5, w0 2,
    # g 3, the sums G, H1, W 2 each; outside the loop the mT parts 5,
    # exy and dxy 6, the spin values 18, the conversions and the f64 sum
    # 10.  General: e_m and d_m 6 more, H4 2; outside, the H4 terms 9
    "polarization_f32": {"folded": 18 + 39 / 12,
                         "general": 26 + 48 / 24},
    # B1's 3+1d mode, one evaluation per (cell, m) and no eta loop: per
    # (cell, row) 48 (the exact products q+ m+, q- m- and abf b 4, two
    # TwoSums 12, the low terms 10, the m+/m- parts of p.dsigma and pi:pp
    # 3 + 8 + 6, abl b, cE, c1, c0b, diffb 5), per evaluation 64 (qx px,
    # qy py 2, three TwoSums 18, the low terms 10, f_eq 6, feqbar 2, E 2,
    # p.dsigma 4, pi:pp 10, delta-f 5, the value 3, the conversion and
    # the f64 sum 2)
    "cooper_frye_comp_3d": 48 + 64,
    # B3's 3+1d mode, one evaluation per (cell, m), one branch per (cell,
    # y).  Modified (df 4 and famod): p' 21, E_mod^2 7, E_mod 2, the
    # exponent and f 7, p.dsigma 7, the value with renorm and red 5, the
    # window 4, the select and the sum 2.  Linearised, f64: u.p and
    # p.dsigma 7 each, pi:pp 23, 1 / E 1, f_eq and feqbar 6, PTB delta-f
    # 10, the value 3, red, the window, the select and the sum 7; famod:
    # u.p and p.dsigma 14, f_eq and the value 7, red, window, select and
    # sum 7
    "cooper_frye_feqmod_3d": {"modified": 55, "breakdown": 64,
                              "famod_modified": 55, "famod_breakdown": 28},
    # P1's 3+1d mode, one evaluation per (cell, m): the mT parts 4 (e0,
    # e3, d0, d3) and the shift A = qa pT 1; the y factor 5 (e_m against
    # (cosh, sinh) 3, - A, exp2) and p.dsigma's (cosh, sinh) part 3; the
    # spin values' (cosh, sinh) parts 14; the phi factor 5 (exy 3, + A,
    # exp2) and the px/py parts of p.dsigma and the spin values 11; f0 4
    # (the product, + sign, the clamp, 1 / x), w 2, g 3, the five terms 8
    # and their f32 sums 5; the conversions and f64 sums once per 256-cell
    # run
    "polarization_f32_3d": 65 + 10 / 256,
}
# What the kernels execute per evaluation, counted the same way from their
# sources (a multiply-add counts two; work shared by a thread's 4 momenta
# counts a quarter, work outside the eta loop a twelfth).
EXECUTED_OPS_PER_EVALUATION = {
    "cooper_frye_comp": 41 + 16 / 4 + 45 / 12,
    "cooper_frye_feqmod": {"modified": 23 + 5 / 4 + 16 / 12,
                           "breakdown": 31 + 4 / 4 + 14 / 12,
                           "famod_modified": 23 + 5 / 4 + 16 / 12,
                           # E 1, p.dsigma 2, f_eq 6, value 1, sum 1; EmT
                           # and pddb per row; gd, exy, the f64 add
                           "famod_breakdown": 11 + 2 / 4 + 9 / 12},
    "cooper_frye_f32": 30 + 21 / 4 + 20 / 12,    # df 2
    # folded: the exponent 1, 2^x 1, + sign 1, clamp 1, reciprocal 5, w0 2,
    # g 3, G, H1, W 2 each; per row e_m, d_m 2; per (cell, m) exy, dxy 6,
    # the spin values 18, the conversions and the f64 adds 10, per (cell,
    # row) the mT parts 5.  General: H4 2 more; per row e_m, d_m 6; per
    # (cell, m) the H4 terms 6 more, per (cell, row) 10 mT parts
    "polarization_f32": {"folded": 20 + 2 / 4 + (34 + 5 / 4) / 12,
                         "general": 22 + 6 / 4 + (40 + 10 / 4) / 24},
    # per evaluation 46: two TwoSums 12, the low terms' three adds 3, expf
    # and its 1 + r and + sign 4, the clamp 1, the reciprocal 5, feqbar 2,
    # E 2, p.dsigma 1, pi:pp 6, delta-f 5, the value 3, the conversion and
    # the f64 add 2; per (cell, phi), shared by the register tile's 7 y
    # rows, 22 (qx px, qy py 2, their TwoSum 6, the low terms dxy 7, the
    # px/py parts of p.dsigma 3 and of pi:pp 4); per (cell, row), shared
    # by its 4 phi, 47 (diffb is dead without diffusion)
    "cooper_frye_comp_3d": 46 + 22 / 7 + 47 / 4,
    # B3's 3+1d mode (a multiply-add counts two).  Modified, in the clean
    # kernel, which takes ~92 % of the main path's cells, per evaluation
    # 33: p' 3, E_mod^2 6, the conversions 2, fmax 1, the square root 7,
    # the exponent 2, exp 1, + sign 1, the clamp 1, the reciprocal 5,
    # p.dsigma 1, the value and renorm 2 (no red), the f64 add 1; per
    # (cell, row), shared by the tile's 2 phi, 12 (U's m+/m- columns 9,
    # p.dsigma's 3; no window); per (cell, phi), shared by its 7 y rows, 12
    # (U's px/py columns 9, p.dsigma's 3).  The mixed kernel's modified
    # branch (the touched cells' rows outside the window) executes more
    # (34 + 15 / 4 + 12 / 3): the bound takes the fewer.  Linearised in
    # f64, per evaluation (nothing shared): df 4 60, famod 24, the window
    # per (cell, row) 3 / 4
    "cooper_frye_feqmod_3d": {"modified": 33 + 12 / 2 + 12 / 7,
                              "breakdown": 60 + 3 / 4,
                              "famod_modified": 33 + 12 / 2 + 12 / 7,
                              "famod_breakdown": 24 + 3 / 4},
    # P1's 3+1d mode, per evaluation 22: the two factors' product + sign 2,
    # the clamp 1, the reciprocal (rcp.approx, no Newton step) 1, p.dsigma
    # and w 2, g 3, the four spin values 4 and their sums 8, W 1; per
    # (cell, y), shared by the tile's 4 phi, 16 (u.p, p.dsigma, the spin
    # values against cosh and sinh 14, the y factor's - A and 2^x 2); per
    # (cell, phi), shared by its 3 y rows, 16 (the px/py parts 14, the phi
    # factor's + A and 2^x 2); per (cell, group), shared by its 12
    # momenta, 11 (the mT parts 10, the shift 1); per 256-cell run, the
    # conversions and f64 adds 10 a momentum
    "polarization_f32_3d": 22 + 16 / 4 + 16 / 3 + 11 / 12 + 10 / 256,
}


def _fewer(a, b):
    if isinstance(a, dict):
        return {k: _fewer(a[k], b[k]) for k in a}
    return min(a, b)


# The bounds count the smaller of the two: a kernel that computes the
# function shows that the function needs no more operations than it does.
BOUND_OPS_PER_EVALUATION = {k: _fewer(OPS_PER_EVALUATION[k],
                                      EXECUTED_OPS_PER_EVALUATION[k])
                            for k in OPS_PER_EVALUATION}
PARITY_CHOSEN = (211, -211, 111, 321, -321, 311, 221, 2212, -2212, 2112,
                 3122, -3122, 3222, 3312, 213, 333)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, warmup=None):
    """Device time of one fn() call after one warm-up call of ``warmup``
    (default: fn), and that call's result."""
    (warmup or fn)()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def launch_counters():
    from is3d2_tpu_torch.ops.cooper_frye_comp import (
        cooper_frye_comp, cooper_frye_comp_3d, cooper_frye_comp_cells)
    from is3d2_tpu_torch.ops.cooper_frye_f32 import cooper_frye_f32
    from is3d2_tpu_torch.ops.cooper_frye_feqmod import cooper_frye_feqmod
    from is3d2_tpu_torch.ops.polarization_f32 import (polarization_f32,
                                                      polarization_f32_3d)
    from is3d2_tpu_torch.ops.cooper_frye_feqmod import cooper_frye_feqmod_3d
    return {"cooper_frye_comp": cooper_frye_comp,
            "cooper_frye_feqmod": cooper_frye_feqmod,
            "cooper_frye_f32": cooper_frye_f32,
            "polarization_f32": polarization_f32,
            "cooper_frye_comp_3d": cooper_frye_comp_3d,
            "cooper_frye_comp_cells": cooper_frye_comp_cells,
            "cooper_frye_feqmod_3d": cooper_frye_feqmod_3d,
            "polarization_f32_3d": polarization_f32_3d}


def bound(ops: float, args: tuple, n_mom: int) -> dict:
    """The least time the card could take for one kernel call on ``args``:
    the larger of ``ops`` over the FP32 peak and the bytes (each operand
    read once, the (n_mom,) f64 output written once; P1 writes 5 M) over
    the memory rate."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor)) + 8 * n_mom
    ops_ms = ops / PEAK_FP32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_environment() -> str:
    print("== 1. environment")
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    print(sh(nvcc, "--version").splitlines()[-1])
    try:
        import triton
        print("triton", triton.__version__)
    except ImportError:
        print("triton: not importable")
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    print("card:", card)
    return card


def fp32_issue_floor_ms(fp32_per_evaluation: float, evaluations: float,
                        clock_max_mhz: int) -> float:
    """The least time the card could take to issue the FP32 instructions
    of ``evaluations`` evaluations: FP32_LANES_PER_SM x H100_SMS lanes at
    ``clock_max_mhz``."""
    return (fp32_per_evaluation * evaluations
            / (FP32_LANES_PER_SM * H100_SMS * clock_max_mhz * 1e6) * 1e3)


def phase_build() -> dict:
    """Builds and loads every source, prints each one's ptxas resources;
    returns the libraries (source -> path) for sass_counts."""
    print("== 2. build (one nvcc per source, in parallel)")
    from is3d2_tpu_torch.ops import _build
    from is3d2_tpu_torch.tools.kernel_check import MAIN_PATH_KERNEL
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, (path, compile_s) in built.items():
        _build.load(name)
        print(f"built {path.name}: nvcc {compile_s:.2f} s")
        usage = _build.resource_usage(path)
        kernels = {k: u for k, u in usage.items() if "add_partials" not in k}
        worst = {key: max(u.get(key, 0) for u in kernels.values())
                 for key in ("registers", "smem", "stack", "spill_stores",
                             "spill_loads")}
        print(f"  {len(kernels)} instantiation(s); the most over them: "
              f"{json.dumps(worst)}")
        for key, pattern in MAIN_PATH_KERNEL.items():
            if SOURCE_OF.get(key, key) != name:
                continue
            if key in SOURCE_OF.values() or key in SOURCE_OF:
                # a source of two kernels: each one's own worst
                stem = KERNEL_NAME.get(key, f"{key}_kernel")
                own = [u for k, u in kernels.items()
                       if re.search(rf"{stem}(?!_)", k)]
                print(f"  {key}: {len(own)} instantiation(s); the most over "
                      f"them: " + json.dumps(
                          {field: max(u.get(field, 0) for u in own)
                           for field in worst}))
            for k, u in kernels.items():
                if re.search(pattern, k):
                    print(f"  {key} main path's instantiation: "
                          f"{json.dumps(u)}")
    print(f"build+load {time.perf_counter() - t0:.2f} s")
    return {name: str(path) for name, (path, _) in built.items()}


def sass_counts(paths: dict) -> tuple[dict, list]:
    """The SASS counts of P1 per instantiation and of B1's main path
    (kernel_bench.loop_nest), of B1's 3+1d mode and of B3's 3+1d clean
    kernel (their cell loops per evaluation, kernel_bench.per_evaluation;
    the clean kernel's with its ptxas registers and spills), from the
    libraries ``paths`` (source -> path), and the lines that say so.
    Parsing cuobjdump's text takes ~15 s: main() runs this in a process of
    its own beside phases 3-5."""
    from is3d2_tpu_torch.ops import _build
    from is3d2_tpu_torch.tools import kernel_bench as kb
    from is3d2_tpu_torch.tools.kernel_check import MAIN_PATH_KERNEL
    lines = []
    code = code_p1 = kb.sass_functions(Path(paths["polarization_f32"]))
    p1 = {}
    for which, pattern in (("folded", r"polarization_f32_kernelILb1EE"),
                           ("general", r"polarization_f32_kernelILb0EE")):
        [name] = [k for k in code if re.search(pattern, k)]
        p1[which] = kb.loop_nest(code[name])
        lines.append(f"P1 {which} SASS: {json.dumps(p1[which])}")
    code = kb.sass_functions(Path(paths["cooper_frye_comp"]))
    [b1] = [k for k in code if re.search(MAIN_PATH_KERNEL["cooper_frye_comp"],
                                         k)]
    b1 = kb.loop_nest(code[b1])
    lines.append(f"B1 SASS: {json.dumps(b1)}")
    [b1_3d] = [k for k in code
               if re.search(MAIN_PATH_KERNEL["cooper_frye_comp_3d"], k)]
    # the cell loop: the innermost loop with an expf
    loop = kb.inner_loops(code[b1_3d])[0]
    b1_3d = kb.per_evaluation(loop)
    lines.append(f"B1 3+1d SASS: the cell loop of {loop['evaluations']} "
                 f"evaluations, per evaluation {json.dumps(b1_3d)}")
    path = Path(paths["cooper_frye_feqmod"])
    code = kb.sass_functions(path)
    [clean] = [k for k in code if re.search(
        MAIN_PATH_KERNEL["cooper_frye_feqmod_3d_clean"], k)]
    loop = kb.inner_loops(code[clean])[0]
    lo, hi = loop["range"]
    opcodes = collections.Counter(op for a, op, _ in code[clean]
                                  if lo <= a <= hi)
    b3_3d_clean = {"per_evaluation": kb.per_evaluation(loop),
                   "evaluations_per_cell_iteration": loop["evaluations"],
                   "opcodes_per_evaluation": {
                       op: n / loop["evaluations"]
                       for op, n in opcodes.most_common()},
                   **_build.resource_usage(path)[clean]}
    lines.append(f"B3 3+1d clean kernel: {json.dumps(b3_3d_clean)}")
    [p1_3d] = [k for k in code_p1 if re.search(
        MAIN_PATH_KERNEL["polarization_f32_3d"], k)]
    loop = kb.inner_loops(code_p1[p1_3d], kb.P1_3D_UNIT)[0]
    p1_3d = {**kb.per_evaluation(loop),
             "evaluations_per_cell_iteration": loop["evaluations"]}
    lines.append(f"P1 3+1d SASS: the cell loop of {loop['evaluations']} "
                 f"evaluations, per evaluation {json.dumps(p1_3d)}")
    return {"p1": p1, "b1": b1, "b1_3d": b1_3d, "b3_3d_clean": b3_3d_clean,
            "p1_3d": p1_3d}, lines


def phase_sass(job) -> dict:
    """sass_counts' result (``job``, its future), its lines printed."""
    print("== 2b. SASS counts (parsed beside phases 3-5)")
    sass, lines = job.result()
    for line in lines:
        print(line)
    return sass


def parity_workdirs(tmp: Path) -> tuple[Path, Path]:
    """The parity workdir, and a copy whose eta table has
    kernel_check.ETA_NODES nodes."""
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import (write_quadrature_tables,
                                                 write_workdir)
    wd = write_workdir(tmp / "compare", n_cells=16,
                       chosen_mcids=PARITY_CHOSEN, include_baryon=True,
                       n_muB=9)
    wd_eta = shutil.copytree(wd, tmp / "compare_eta")
    write_quadrature_tables(wd_eta, 51, 48, kc.ETA_NODES)
    return wd, wd_eta


def check_eta_chunks(r, chunk: int) -> None:
    """An ETA_NODES case: its bars, and one launch per chunk of eta."""
    from is3d2_tpu_torch.tools import kernel_check as kc
    chunks = -(-kc.ETA_NODES // chunk)
    print(f"{kc.ETA_NODES} eta nodes, not folded ({r.launches} launches) "
          f"kernel vs plain {r.vs_plain:.3e}  kernel vs f64 {r.vs_f64:.3e}  "
          f"max |kernel - plain| {np.abs(r.kernel - r.plain).max():.3e}")
    if not (r.ok and r.launches == chunks):
        raise AssertionError(f"{kc.ETA_NODES} eta nodes: kernel disagrees, "
                             f"does not repeat or launched {r.launches} "
                             f"times, not {chunks} ({r.vs_plain:.3e} vs "
                             f"plain, {r.vs_f64:.3e} vs f64)")


def phase_b1_compare(wd: Path, wd_eta: Path) -> None:
    print("== 3. B1 vs plain version vs f64 engine (2048 cells, 16 species, "
          "51 x 48, 24 eta)")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.tools import kernel_check as kc
    for name in kc.CASES:
        r = kc.check_case(wd, name, 2048, 7, "cuda")
        print(f"{name:22s} kernel vs plain {r.vs_plain:.3e}  kernel vs f64 "
              f"{r.vs_f64:.3e}  plain vs f64 {r.plain_vs_f64:.3e}  max |kernel"
              f" - plain| {np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees or does not "
                                 f"repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")
    for name in ("df1", "df2"):
        # the kernel's kShear = false instantiations
        r = kc.check_case(wd, name, 2048, 7, "cuda", include_shear_deltaf=0)
        print(f"{name + '-noshear':22s} kernel vs plain {r.vs_plain:.3e}  "
              f"kernel vs f64 {r.vs_f64:.3e}  plain vs f64 "
              f"{r.plain_vs_f64:.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}-noshear: kernel disagrees or does "
                                 f"not repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")
    r = kc.check_ragged_case(wd, 2048, 7, "cuda")
    print(f"{'ragged ' + json.dumps(kc.RAGGED):22s} kernel vs plain "
          f"{r.vs_plain:.3e}  max |kernel - plain| "
          f"{np.abs(r.kernel - r.plain).max():.3e}")
    if not (r.ok and r.launches == 1):
        raise AssertionError(f"B1 ragged case: kernel disagrees or does not "
                             f"repeat ({r.vs_plain:.3e} vs plain)")
    check_eta_chunks(kc.check_case(wd_eta, "df1", 2048, 7, "cuda",
                                   eta_fold=0), ck.ETA_CHUNK)


def phase_b3_compare(wd: Path, wd_eta: Path) -> None:
    print("== 4. B3 vs plain version vs f64 feqmod engine (2048 cells, "
          "16 species, 51 x 48, 24 eta; shear 0.2, bulk 0.1)")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    results = {name: kc.check_feqmod_case(wd, name, 2048, 7, "cuda")
               for name in kc.FEQMOD_CASES}
    results["famod (real prep)"] = kc.check_famod_case(wd, 2048, 7, "cuda",
                                                       cell_block=512)
    results["df4 ragged"] = kc.check_feqmod_ragged_case(wd, 2048, 7, "cuda")
    for name, r in results.items():
        print(f"{name:22s} breakdown cells {r.breakdown_cells:4d}  kernel vs "
              f"plain {r.vs_plain:.3e}  kernel vs f64 {r.vs_f64:.3e}  plain vs"
              f" f64 {r.plain_vs_f64:.3e}  max |kernel - plain| "
              f"{np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees, does not repeat "
                                 f"or no cell breaks down ({r.vs_plain:.3e} vs"
                                 f" plain, {r.vs_f64:.3e} vs f64, "
                                 f"{r.breakdown_cells} breakdowns)")
    check_eta_chunks(kc.check_feqmod_case(wd_eta, "df4", 2048, 7, "cuda",
                                          eta_fold=0), fk.ETA_CHUNK)


def run_main_path(tmp: Path, label: str, kernel: str, params: dict,
                  also: tuple = (), **surface_kw
                  ) -> tuple[dict, dict, Path, str]:
    """Write the full-size workdir and run the operation-1 CLI on it
    (run_cli: ``kernel`` and ``also`` launch, no other), then check its
    spectra files.  Returns every kernel's launches, the stage seconds,
    the workdir and the log."""
    from is3d2_tpu_torch.tools.synthetic import write_workdir

    t0 = time.perf_counter()
    wd = write_workdir(tmp / label, n_cells=MAIN_CELLS, params=params,
                       **surface_kw)
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, out = run_cli(wd, kernel, also)

    res = wd / "results/continuous"
    mcids = [int(v) for v in np.loadtxt(wd / "PDG/chosen_particles.dat")]
    for m in mcids:
        v = np.loadtxt(res / f"dN_pTdpTdphidy_{m}.dat", skiprows=1)[:, 3]
        if v.shape != (51 * 48,) or not np.isfinite(v).all() or (v < 0).any():
            raise AssertionError(f"spectra of {m}: bad shape, value or sign")
    dndy = {m: float(np.loadtxt(res / f"dN_dy_{m}.dat")[1])
            for m in (211, 321, 2212)}
    print(f"{len(mcids)} species; dN/dy pi+ {dndy[211]:.6g}  K+ "
          f"{dndy[321]:.6g}  p {dndy[2212]:.6g}")
    if not dndy[211] > dndy[321] > dndy[2212] > 0:
        raise AssertionError("dN/dy is not ordered pi+ > K+ > p")
    return launches, stages, wd, out


def run_cli(wd: Path, kernel: str | None, also: tuple = ()
            ) -> tuple[dict, dict, str]:
    """cli.main on a workdir with every launch count set to 0 just before
    and read just after.  Only ``kernel`` and the kernels ``also`` may
    launch, and each must (with ``kernel`` None, none may).  Returns every
    kernel's launches, the driver's stage seconds and the log."""
    from is3d2_tpu_torch import cli
    counters = launch_counters()
    log = io.StringIO()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    out = log.getvalue()
    print(out, end="")
    print(f"cli.main returned {rc} after {wall:.2f} s; kernel launches "
          f"{launches}")
    ours = (kernel, *also) if kernel else ()
    if rc != 0 or any(launches[k] < 1 for k in ours):
        raise AssertionError(f"the main path did not run through {ours}")
    if any(n for name, n in launches.items() if name not in ours):
        raise AssertionError(f"the {kernel} main path launched another kernel")
    stages = json.loads(re.search(r"^stage seconds: (.*)$", out,
                                  re.M).group(1))
    return launches, stages, out


def phase_b1_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 5. df-1 main path: {MAIN_CELLS} cells, all species, 51 x 48 "
          "x 24, f32c")
    launches, stages, wd, _ = run_main_path(
        tmp, "main_df1", "cooper_frye_comp",
        {"df_mode": 1, "compute_dtype": "f32c"})
    return launches["cooper_frye_comp"], stages, wd


def compare_on_cut(kernel, plain, few_args, cut_args, spectra_units, tol,
                   name):
    """Kernel and plain version on the cut operands, both timed; the plain
    version warms up on ``few_args``.  Returns (kernel ms, plain ms,
    max |kernel - plain| in spectra units)."""
    ms, out = cuda_ms(lambda: kernel(*cut_args))
    plain_ms, ref = cuda_ms(lambda: plain(*cut_args),
                            warmup=lambda: plain(*few_args))
    print(f"cut: kernel {ms:.1f} ms, plain version {plain_ms:.1f} ms "
          f"({plain_ms / ms:.1f}x the kernel)")
    kern = spectra_units(out)
    ref = spectra_units(ref)
    from is3d2_tpu_torch.tools import kernel_check as kc
    rel = kc.max_rel_err(kern, ref)
    max_abs = float(np.abs(kern - ref).max())
    print(f"kernel vs plain: max relative {rel:.3e} on bins >= {kc.FLOOR:g} "
          f"of peak, max |kernel - plain| {max_abs:.3e}")
    if not (np.isfinite(kern).all() and rel <= tol):
        raise AssertionError(f"{name} disagrees with its plain version on the "
                             f"main path's operands ({rel:.3e})")
    return ms, plain_ms, max_abs


def main_path_state(wd: Path, state_fn):
    """(cfg, engine state) of a main path, read back from its workdir."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.io.surface import read_surface

    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", cfg.mode, cfg.dimension,
                        bool(cfg.include_baryon))
    return cfg, state_fn(wd, cfg, surf, "cuda")


def time_on_main_path(name, kernel, plain, ops, args, cut, n_cut, state, tol,
                      ops_of, launched=None) -> dict:
    """Time ``kernel`` on the main path's operands ``args`` (``ops``), then
    hold it to its plain version on the first ``n_cut`` cells (``cut(n)``:
    the operands cut to n cells), both timed there.  ``ops_of(n)``: the
    operations on the first n cells, for the bounds.  ``launched()``: the
    grid geometry of the wrapper's latest launch, where it records one."""
    from is3d2_tpu_torch.tools import kernel_check as kc

    C, Ne, M = args[0].shape[0], ops.eta.shape[0], ops.mom.shape[1]
    print(f"{C} padded cells x {Ne} eta x {M} momenta (M mod 256 = "
          f"{M % 256}) = {ops.evaluations:.4g} evaluations")
    first = kernel(*args)
    full_ms, second = cuda_ms(lambda: kernel(*args), warmup=lambda: None)
    print(f"kernel at full size {full_ms:.1f} ms, "
          f"{ops.evaluations / full_ms * 1e3:.4g} evaluations/s")
    if not torch.equal(first, second):
        raise AssertionError(f"two launches of {name} on the main path's "
                             "operands gave different bits")
    print("two launches at full size gave equal bits")
    del first, second
    shape = {}
    if launched is not None:
        g = launched()
        print(f"launched with {g}")
        shape = {"register_tile": g.r, "cell_split": g.n_split}
    print(f"compared on the first {n_cut} cells at the full M")
    ms, plain_ms, max_abs = compare_on_cut(
        kernel, plain, cut(64), cut(n_cut),
        lambda flat: kc.spectra_units(state, flat), tol, name)
    main_bound = bound(ops_of(C), args, M)["bound_ms"]
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / full_ms:.1f} % of it")
    return {**shape, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(ops_of(n_cut), cut(n_cut), M),
            "main_path_bound_ms": main_bound,
            "main_path_evaluations_per_s": ops.evaluations / full_ms * 1e3,
            "main_path_share_of_bound": main_bound / full_ms,
            # no single PyTorch call computes a Cooper-Frye sum
            "library_ms": None,
            "cells_compared": n_cut, "main_path_ms": full_ms,
            "main_path_evaluations": ops.evaluations}


def phase_b1_full(wd: Path, stages: dict, sass: dict) -> dict:
    print("== 6. B1 on the df-1 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops.spectra_fast_common import comp_operands
    from is3d2_tpu_torch.tools import kernel_check as kc

    print(f"driver stage seconds: {json.dumps(stages)}")
    cfg, state = main_path_state(wd, kc.engine_state)
    ops = comp_operands(*state, cfg)
    args = (*ops.args(), cfg)
    per_cell = (BOUND_OPS_PER_EVALUATION["cooper_frye_comp"] * ops.evaluations
                / ops.cell.shape[0])
    r = time_on_main_path(
        "B1", functools.partial(ck.cooper_frye_comp, row_len=ops.row_len),
        ck.cooper_frye_comp_plain, ops, args,
        lambda n: (ops.cell[:n].contiguous(), ops.qm[:n].contiguous(),
                   *args[2:]),
        B1_COMPARE_CELLS, state, kc.TOL, lambda n: per_cell * n,
        lambda: ck.cooper_frye_comp.last_geometry)
    # the eta loop's FP32 instructions, and the cell step's shared by the
    # register tile's momenta and the eta nodes
    fp32 = (sass["eta_loop_per_evaluation"]["fp32"]
            + sass["cell_step"]["fp32"]
            / (sass["evaluations_per_eta_iteration"] * ops.eta.shape[0]))
    _, clock_max = sm_clocks()
    floor = fp32_issue_floor_ms(fp32, ops.evaluations, clock_max)
    print(f"fp32_issue_floor_ms {floor:.1f} ({fp32:.2f} FP32 instructions an "
          f"evaluation over {FP32_LANES_PER_SM} x {H100_SMS} lanes at "
          f"{clock_max} MHz): {100 * floor / r['main_path_ms']:.1f} % of it")
    return {**r, "fp32_per_evaluation": fp32, "fp32_issue_floor_ms": floor,
            "main_path_share_of_fp32_floor": floor / r["main_path_ms"]}


def phase_b3_main_path(tmp: Path) -> tuple[int, dict, Path]:
    from is3d2_tpu_torch.tools import kernel_check as kc
    print(f"== 7. df-4 main path: {MAIN_CELLS} cells, all species, 51 x 48 "
          "x 24, f32, shear 0.2, bulk 0.1")
    launches, stages, wd, out = run_main_path(
        tmp, "main_df4", "cooper_frye_feqmod",
        {"df_mode": 4, "compute_dtype": "f32"}, **kc.FEQMOD_SURFACE)
    n_break = int(re.search(r"^feqmod breaks down for (\d+) /", out,
                            re.M).group(1))
    print(f"breakdown cells: {n_break}")
    if n_break < 1:
        raise AssertionError("no cell of the df-4 main path broke down")
    print(f"stage seconds: {json.dumps(stages)}")
    return launches["cooper_frye_feqmod"], stages, wd


def phase_b3_full(wd: Path) -> dict:
    print("== 8. B3 on the df-4 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.feqmod_engine_state)
    ops = fk.feqmod_operands(*state, cfg)
    n_break = int((state[1].breaks_down[:B3_COMPARE_CELLS]
                   & (state[0].mask[:B3_COMPARE_CELLS] > 0)).sum().item())
    print(f"{kc.breakdown_cells(state)} breakdown cells, {n_break} of them "
          f"among the first {B3_COMPARE_CELLS}")
    if n_break < 1:
        raise AssertionError("no breakdown cell among the compared cells")
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod"]
    per_cell = ops.evaluations / ops.cols.shape[0]

    def b3_ops(n):
        """Operations on the first n operand cells: the kernel runs the
        breakdown branch on the cells whose BREAKS column is set."""
        n_b = int((ops.cols[:n, fk.BREAKS] != 0).sum().item())
        return per_cell * (n_b * per_eval["breakdown"]
                           + (n - n_b) * per_eval["modified"])

    return time_on_main_path(
        "B3", functools.partial(fk.cooper_frye_feqmod, row_len=ops.row_len),
        fk.cooper_frye_feqmod_plain, ops, (*ops.args(), cfg, ops.kind),
        lambda n: (ops.cols[:n].contiguous(), ops.mom,
                   ops.renorm[:n].contiguous(), ops.red[:n].contiguous(),
                   ops.eta, ops.n_per_species, cfg, ops.kind),
        B3_COMPARE_CELLS, state, kc.FEQMOD_TOL_PLAIN, b3_ops,
        lambda: fk.cooper_frye_feqmod.last_geometry.grid)


def phase_b2_compare(wd: Path, wd_eta: Path) -> None:
    print("== 9. B2 vs plain version vs f64 engine (2048 cells, 16 species, "
          "51 x 48, 24 eta; f64, use_pallas 1)")
    from is3d2_tpu_torch.ops import cooper_frye_f32 as b2
    from is3d2_tpu_torch.tools import kernel_check as kc
    for name in kc.F32_CASES:
        r = kc.check_f32_case(wd, name, 2048, 7, "cuda")
        print(f"{name:22s} kernel vs plain {r.vs_plain:.3e}  kernel vs f64 "
              f"{r.vs_f64:.3e}  plain vs f64 {r.plain_vs_f64:.3e}  max |kernel"
              f" - plain| {np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees or does not "
                                 f"repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")
    r = kc.check_f32_ragged_case(wd, 2048, 7, "cuda")
    print(f"{'ragged ' + json.dumps(kc.RAGGED):22s} kernel vs plain "
          f"{r.vs_plain:.3e}  max |kernel - plain| "
          f"{np.abs(r.kernel - r.plain).max():.3e}")
    if not (r.ok and r.launches == 1):
        raise AssertionError(f"B2 ragged case: kernel disagrees or does not "
                             f"repeat ({r.vs_plain:.3e} vs plain)")
    check_eta_chunks(kc.check_f32_case(wd_eta, "df2", 2048, 7, "cuda",
                                       eta_fold=0), b2.ETA_CHUNK)


def phase_b2_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 10. use_pallas = 1 main path: {MAIN_CELLS} cells, all species, "
          "51 x 48 x 24, df 2, f64")
    launches, stages, wd, _ = run_main_path(
        tmp, "main_df2_pallas", "cooper_frye_f32",
        {"df_mode": 2, "compute_dtype": "f64", "use_pallas": 1})
    print(f"stage seconds: {json.dumps(stages)}")
    return launches["cooper_frye_f32"], stages, wd


def phase_b2_full(wd: Path) -> dict:
    print("== 11. B2 on the use_pallas = 1 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_f32 as b2
    from is3d2_tpu_torch.ops.spectra_fast_common import f32_operands
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.engine_state)
    ops = f32_operands(*state, cfg)
    args = (*ops.args(), cfg)
    per_cell = (BOUND_OPS_PER_EVALUATION["cooper_frye_f32"] * ops.evaluations
                / ops.cell.shape[0])
    return time_on_main_path(
        "B2", functools.partial(b2.cooper_frye_f32, row_len=ops.row_len),
        b2.cooper_frye_f32_plain, ops, args,
        lambda n: (ops.cell[:n].contiguous(), *args[1:]),
        B2_COMPARE_CELLS, state, kc.F32_TOL_PLAIN, lambda n: per_cell * n,
        lambda: b2.cooper_frye_f32.last_geometry)


SAMPLER_SEED = 20261017
# cuRAND's Poisson draw takes a normal approximation above this mean
CURAND_POISSON_NORMAL = 4000.0


def derived_workdir(tmp: Path, src: Path, label: str, params: dict) -> Path:
    """A copy of a main path's workdir (no results) with its parameters
    updated, e.g. to an operation-2 or operation-0 run."""
    wd = shutil.copytree(src, tmp / label,
                         ignore=shutil.ignore_patterns("results"))
    p = wd / "iS3D_parameters.dat"
    kv = dict(line.split(" = ", 1) for line in p.read_text().splitlines())
    kv.update({k: str(v) for k, v in params.items()})
    p.write_text("".join(f"{k} = {v}\n" for k, v in kv.items()))
    return wd


def run_op2(wd: Path) -> dict:
    """cli.main on an operation-2 workdir with every kernel's launch count
    set to 0 just before and read just after (operation 2 launches none);
    returns what its log says."""
    from is3d2_tpu_torch import cli
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    out = log.getvalue()
    print(out, end="")
    print(f"cli.main returned {rc} after {wall:.2f} s; kernel launches "
          f"{launches}")
    if rc != 0 or any(launches.values()):
        raise AssertionError("the operation-2 path failed or launched a "
                             "Cooper-Frye kernel")
    m = re.search(r"Estimated total particle yield = (\d+) particles; "
                  r"sampling (\d+) events", out, re.M)
    k = re.search(r"sampled hadrons: (\d+) kept / (\d+) drawn", out)
    r = {"wall_s": wall, "Ntot": int(m.group(1)), "n_events": int(m.group(2)),
         "kept": int(k.group(1)), "drawn": int(k.group(2)),
         "stage_seconds": json.loads(re.search(r"^stage seconds: (.*)$", out,
                                               re.M).group(1)),
         "momentum_efficiency_pct": float(re.search(
             r"Momentum sampling efficiency = ([0-9.]+) %", out).group(1)),
         "syncs_per_chunk": float(re.search(
             r"([0-9.]+) device syncs per chunk", out).group(1)),
         "chunks": int(re.search(r"sampler: (\d+) chunk", out).group(1)),
         "dropped_lanes": 0}
    d = re.search(r"WARNING: (\d+) hadron lanes", out)
    if d:
        r["dropped_lanes"] = int(d.group(1))
    comp = r["stage_seconds"]["compute"]
    r.update(drawn_per_kept=r["drawn"] / r["kept"],
             kept_per_s=r["kept"] / comp, drawn_per_s=r["drawn"] / comp)
    print(f"kept {r['kept']} / drawn {r['drawn']} (drawn/kept "
          f"{r['drawn_per_kept']:.4f}) over {r['n_events']} events in "
          f"{r['chunks']} chunks; {r['kept_per_s']:.4g} kept and "
          f"{r['drawn_per_s']:.4g} drawn hadrons per second of compute; "
          f"momentum efficiency {r['momentum_efficiency_pct']:.4f} %; "
          f"{r['syncs_per_chunk']} syncs per chunk")
    Ntot, n = r["Ntot"], r["n_events"]
    per_event = r["kept"] / n
    bar = 0.05 * Ntot + 5.0 * np.sqrt(Ntot / n)
    print(f"kept per event {per_event:.2f} vs the estimate Ntot = {Ntot} "
          f"(bar {bar:.2f})")
    if abs(per_event - Ntot) >= bar:
        raise AssertionError("kept yield outside the estimate's bound")
    if r["dropped_lanes"]:
        raise AssertionError(f"{r['dropped_lanes']} lanes were dropped")
    return r


def phase_timings(wd: Path) -> dict:
    """The six phase functions on one full chunk of the workdir's campaign,
    each timed with CUDA events; a warm-up chunk first, then the timed
    chunk and a repeat with the same seed, which must give equal bits.
    Also checks torch.poisson on the card at the chunk's largest mean."""
    from is3d2_tpu_torch.core import sampler as ps
    from is3d2_tpu_torch.driver import IS3D
    run = IS3D(wd, device="cuda")
    run.load_surface_from_file()
    run._setup()
    setup, species, _ = ps.prepare_setup(
        run.surface, run.species, run.chosen_idx, run.df_data, run.cfg,
        run.laguerre, run.device)
    camp = ps.prepare_campaign(setup, species,
                               run.species.mc_id[run.chosen_idx], run.cfg)
    Ntot = ps.compute_total_yield(run.surface, run.species, run.chosen_idx,
                                  run.df_data, run.cfg, run.laguerre,
                                  run.device)
    n_ev = ps.chunk_plan(camp.mean_1ev, ps.number_of_events(Ntot, run.cfg),
                         run.cfg)
    lam_max = float(camp.lam_1ev.max()) * n_ev
    print(f"one full chunk: {n_ev} events, mean {camp.mean_1ev * n_ev:.4g} "
          f"drawn lanes, largest Poisson mean per cell {lam_max:.1f}")
    lam = torch.full((4_000_000,), lam_max, dtype=torch.float64, device="cuda")
    draws = torch.poisson(lam, generator=ps.chunk_generator(1, 0, "cuda"))
    mean, var = float(draws.mean()), float(draws.var())
    sig = np.sqrt(lam_max / draws.numel())
    print(f"torch.poisson at that mean: mean {mean:.4f} var {var:.4f} "
          f"(mean's sigma {sig:.4f}; cuRAND's normal approximation starts "
          f"above {CURAND_POISSON_NORMAL:g})")
    if abs(mean - lam_max) > 5 * sig or abs(var / lam_max - 1.0) > 0.01:
        raise AssertionError("torch.poisson on the card is off at the "
                             "chunk's largest mean")
    del lam, draws

    def chunk(seed, marks=None):
        stats = ps.ChunkStats()
        out = ps.sample_chunk(camp, n_ev, 0,
                              ps.chunk_generator(seed, 0, "cuda"), stats,
                              mark=marks)
        torch.cuda.synchronize()
        return out, stats

    chunk(SAMPLER_SEED + 1)
    events = [torch.cuda.Event(enable_timing=True)]
    names = []

    def mark(phase):
        names.append(phase)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    t0 = time.perf_counter()
    events[0].record()
    a, stats = chunk(SAMPLER_SEED, mark)
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {n: events[i].elapsed_time(events[i + 1])
          for i, n in enumerate(names)}
    print(f"phase ms on one chunk ({stats.drawn} drawn, {stats.kept} kept, "
          f"{stats.syncs} syncs): {json.dumps(ms)}; sum "
          f"{sum(ms.values()):.1f} ms, host wall {wall_ms:.1f} ms")
    b, _ = chunk(SAMPLER_SEED)
    same = all(torch.equal(a[k], b[k]) for k in a
               if isinstance(a[k], torch.Tensor))
    if not same:
        raise AssertionError("one chunk run twice with one seed gave "
                             "different bits")
    print("one chunk run twice with one seed gave equal bits")
    return {"phase_ms": ms, "chunk_events": n_ev, "chunk_drawn": stats.drawn,
            "chunk_kept": stats.kept, "chunk_syncs": stats.syncs,
            "chunk_wall_ms": wall_ms, "largest_poisson_mean": lam_max}


def phase_sampler_histograms(tmp: Path, wd1: Path) -> dict:
    print(f"== 12. op-2 histogram main path: {MAIN_CELLS} cells, all "
          "species, df 1, test_sampler 1, fast 1, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd1, "op2_hist", {
        "operation": 2, "test_sampler": 1, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    if r["drawn_per_kept"] >= 2.7:
        raise AssertionError("drawn/kept >= 2.7: the tilted envelope is off")
    # (outflow and regulation off in phase 5; they move dN/dy by ~5e-4 here)
    r["closure"] = dndy_closure(wd, wd1, r["n_events"])
    r.update(phase_timings(wd))
    return r


def dndy_closure(wd: Path, wd_op1: Path, n_events: int) -> dict:
    """The sampled dN/dy of pi+, K+ and p (the test histograms of ``wd``)
    against the op-1 dN_dy files of ``wd_op1``: within 5 sigma + 1%."""
    from is3d2_tpu_torch.config import Config
    norm = 2.0 * Config.from_file(wd / "iS3D_parameters.dat").y_cut * n_events
    closure = {}
    for m in (211, 321, 2212):
        smooth = float(np.loadtxt(
            wd_op1 / f"results/continuous/dN_dy_{m}.dat")[1])
        avg = float(np.loadtxt(
            wd / f"results/sampled/dN_dy/dN_dy_{m}_average_test.dat"))
        n = avg * norm
        sigma = np.sqrt(max(n, 1.0)) / norm
        closure[str(m)] = {"sampled": avg, "smooth": smooth, "sigma": sigma}
        print(f"dN/dy {m}: sampled {avg:.6g} (sigma {sigma:.3g}) vs op-1 "
              f"{smooth:.6g}: {(avg - smooth) / smooth:+.3e} relative")
        if abs(avg - smooth) >= 5.0 * sigma + 0.01 * smooth:
            raise AssertionError(f"dN/dy closure of {m} fails")
    return closure


def phase_sampler_oscar(tmp: Path, wd4: Path) -> dict:
    print(f"== 13. op-2 OSCAR path: {MAIN_CELLS} cells, all species, df 4 "
          "(shear 0.2, bulk 0.1), test_sampler 0, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd4, "op2_oscar", {
        "operation": 2, "test_sampler": 0, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    rows = check_oscar_files(wd, r)
    st = r["stage_seconds"]
    print(f"write {st['write']:.3f} s (of it {st['write_boost']:.3f} s the "
          f"host boost, {st['write_overlapped']:.3f} s overlapped with "
          f"compute; {st['write_exposed']:.3f} s exposed after compute), "
          f"waiting for device->host copies "
          f"{st['write_transfer']:.3f} s")
    r["oscar_rows"] = rows
    return r


def check_oscar_files(wd: Path, r: dict) -> int:
    """The OSCAR files of an operation-2 run (``r``: run_op2's): one per
    event, each with the OSCAR header and 11 columns, rows summing to the
    kept count.  Returns the rows."""
    files = sorted((wd / "results").glob("particle_list_osc_*.dat"))
    if len(files) != r["n_events"]:
        raise AssertionError(f"{len(files)} OSCAR files for "
                             f"{r['n_events']} events")
    t0 = time.perf_counter()
    rows = 0
    for f in files:
        data = f.read_bytes()
        head, _, body = data.partition(b"\n")
        if head != b"n pid px py pz E m x y z t":
            raise AssertionError(f"{f.name}: header {head!r}")
        first = body.split(b"\n", 1)[0].split()
        if len(first) != 11:
            raise AssertionError(f"{f.name}: {len(first)} columns")
        rows += body.count(b"\n")
    print(f"{len(files)} files, {rows} rows, "
          f"{sum(f.stat().st_size for f in files) / 1e9:.3f} GB "
          f"(counted in {time.perf_counter() - t0:.1f} s)")
    if rows != r["kept"]:
        raise AssertionError(f"{rows} OSCAR rows, {r['kept']} kept")
    return rows


def phase_famod_main_path(tmp: Path) -> tuple[int, dict, Path, dict]:
    from is3d2_tpu_torch.tools import kernel_check as kc
    print(f"== 14. df-5 main path: {MAIN_CELLS} cells (EOS-consistent), all "
          "species, 51 x 48 x 24, f32, shear 0.1, bulk 0.05")
    launches, stages, wd, out = run_main_path(
        tmp, "main_df5", "cooper_frye_feqmod",
        {"df_mode": 5, "compute_dtype": "f32"}, eos_consistent=True,
        device="cuda", **kc.FAMOD_SURFACE)

    def count(pattern):
        return int(re.search(pattern, out, re.M).group(1))

    info = {"breakdown_cells": count(r"^famod breaks down for (\d+) /"),
            "pl_negative_cells": count(r"^pl went negative for (\d+) /"),
            "reconstruction_failures": count(
                r"^Number of reconstruction failures = (\d+)"),
            "newton_iterations": count(r"(\d+) Newton iterations"),
            "stage_seconds": stages}
    print(f"famod: {json.dumps(info)}")
    if info["breakdown_cells"] < 1:
        raise AssertionError("no cell of the df-5 main path broke down")
    return launches["cooper_frye_feqmod"], stages, wd, info


def phase_famod_full(wd: Path) -> dict:
    print("== 15. B3's famod mode on the df-5 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.famod_engine_state)
    ops = fk.famod_operands(*state, cfg)
    n_break = int((state[1].breaks_down[:B3_COMPARE_CELLS]
                   & (state[0].mask[:B3_COMPARE_CELLS] > 0)).sum().item())
    print(f"{kc.breakdown_cells(state)} breakdown cells, {n_break} of them "
          f"among the first {B3_COMPARE_CELLS}")
    if n_break < 1:
        raise AssertionError("no breakdown cell among the compared cells")
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod"]
    per_cell = ops.evaluations / ops.cols.shape[0]

    def famod_ops(n):
        """Operations on the first n operand cells, by the branch each
        cell takes."""
        n_b = int((ops.cols[:n, fk.BREAKS] != 0).sum().item())
        return per_cell * (n_b * per_eval["famod_breakdown"]
                           + (n - n_b) * per_eval["famod_modified"])

    return time_on_main_path(
        "B3 famod", functools.partial(fk.cooper_frye_feqmod,
                                      row_len=ops.row_len),
        fk.cooper_frye_feqmod_plain, ops, (*ops.args(), cfg, ops.kind),
        lambda n: (ops.cols[:n].contiguous(), ops.mom,
                   ops.renorm[:n].contiguous(), ops.red[:n].contiguous(),
                   ops.eta, ops.n_per_species, cfg, ops.kind),
        B3_COMPARE_CELLS, state, kc.FEQMOD_TOL_PLAIN, famod_ops,
        lambda: fk.cooper_frye_feqmod.last_geometry.grid)


def phase_famod_sampler(tmp: Path, wd5: Path) -> dict:
    print(f"== 16. op-2 df-5 histograms: phase 14's {MAIN_CELLS} cells, all "
          "species, test_sampler 1, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd5, "op2_df5", {
        "operation": 2, "test_sampler": 1, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    r["closure"] = dndy_closure(wd, famod_reference(tmp, wd5), r["n_events"])
    r.update(phase_timings(wd))
    return r


def famod_reference(tmp: Path, wd5: Path) -> Path:
    """Phase 14's surface through the op-1 CLI (B3's famod mode) on tables
    that resolve dN/dy: pi+, K+ and p, 96 eta nodes (48 folded) and 64 pT
    up to 6 GeV.  Phase 14's north-star tables (24 eta nodes, pT <= 3 GeV)
    leave protons a few percent low (the 24 nodes ~1.6 %, the pT cut ~2 %
    on this flow), which the sampler, drawing every momentum, does not."""
    from is3d2_tpu_torch import cli
    from is3d2_tpu_torch.tools.synthetic import write_quadrature_tables
    wd = shutil.copytree(wd5, tmp / "main_df5_fine",
                         ignore=shutil.ignore_patterns("results"))
    write_quadrature_tables(wd, 64, 48, 96, pT_max=6.0)
    (wd / "PDG/chosen_particles.dat").write_text("211\n321\n2212\n")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    stages = re.search(r"^stage seconds: (.*)$", log.getvalue(), re.M)
    print(f"op-1 reference (pi+ K+ p, 96 eta, 64 pT to 6 GeV): rc {rc}, "
          f"stage seconds {stages.group(1)}")
    if rc != 0:
        raise AssertionError("the op-1 reference run failed")
    return wd


# The grouping's own error: grouped against ungrouped spectra, the max
# relative error over the species on bins >= 1e-4 of each species' peak.
# The JAX package's group_particles gives 0.0709 on the synthetic list's
# surface (512 cells) at particle_diff_tolerance 0.01, from eta' grouped
# with a radial eta excitation 9.9 MeV below it (CPU; tests/
# test_torch_group.py::test_the_grouping_bar_of_the_chip_check prints it,
# holds the port's error to the JAX package's and both under this bar).
GROUP_BAR = 0.075
GROUP_BAR_SOURCE = ("the JAX package's grouping error on this list, "
                    "0.0709 at 512 cells on the CPU")


def phase_grouped_main_path(tmp: Path) -> dict:
    print(f"== 17. mode-6 grouped main path: {MAIN_CELLS} cells written in "
          "mode 6, all species, 51 x 48 x 24, df 1, f32c, group_particles 1")
    from is3d2_tpu_torch.core.spectra import compute_spectra, df12_state
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops.spectra_fast_common import comp_operands
    from is3d2_tpu_torch.tools import kernel_check as kc
    launches, stages, wd, _ = run_main_path(
        tmp, "main_mode6_grouped", "cooper_frye_comp",
        {"df_mode": 1, "compute_dtype": "f32c", "group_particles": 1},
        surface_mode=6)
    print(f"stage seconds: {json.dumps(stages)}")
    run = IS3D(wd, device="cuda")
    run.load_surface_from_file()
    run._setup()
    cfg, idx, table = run.cfg, run.chosen_idx, run.species
    rep, group_of = table.group_species(idx, cfg.particle_diff_tolerance,
                                        bool(cfg.include_baryon))
    state = df12_state(run.surface, table, idx[rep], run.grids, run.df_data,
                       cfg, "cuda")
    ops = comp_operands(*state, cfg)
    args = (*ops.args(), cfg)
    ms, _ = cuda_ms(lambda: ck.cooper_frye_comp(*args, row_len=ops.row_len))
    geometry = ck.cooper_frye_comp.last_geometry
    M = ops.mom.shape[1]
    per_species = M // len(rep)
    print(f"{len(idx)} species -> {len(rep)} representatives: M "
          f"{len(idx) * per_species} -> {M}; B1 {ms:.1f} ms "
          f"({ops.evaluations / ms * 1e3:.4g} evaluations/s), launched with "
          f"{geometry}")
    surf = (run.surface, table, idx, run.grids, run.df_data)
    grouped = compute_spectra(*surf, cfg, "cuda")
    plain = compute_spectra(*surf, dataclasses.replace(cfg,
                                                       group_particles=0),
                            "cuda")
    key = np.stack([table.mass, table.sign, table.baryon], axis=1)
    exact = [i for i in range(len(idx))
             if (key[idx[i]] == key[idx[rep[group_of[i]]]]).all()]
    exact_err = kc.max_rel_err(grouped[exact], plain[exact])
    errs = np.array([kc.max_rel_err(grouped[i:i + 1], plain[i:i + 1])
                     for i in range(len(idx))])
    worst = int(np.argmax(errs))
    print(f"{len(exact)} species share (mass, sign, baryon) with their "
          f"representative: grouped vs ungrouped {exact_err:.3e} (bar "
          f"1e-12); every species: max {errs[worst]:.4e} "
          f"({int(table.mc_id[idx[worst]])}), median {np.median(errs):.4e}; "
          f"bar {GROUP_BAR:.4e}, {GROUP_BAR_SOURCE}")
    if not (np.isfinite(grouped).all() and exact_err <= 1e-12
            and errs.max() <= GROUP_BAR):
        raise AssertionError("the grouped main path is off its ungrouped "
                             "run beyond the grouping's bar")
    bnd = bound(BOUND_OPS_PER_EVALUATION["cooper_frye_comp"]
                * ops.evaluations, args, M)
    return {"launches": launches["cooper_frye_comp"],
            "stage_seconds": stages,
            "species": len(idx), "representatives": len(rep), "momenta": M,
            "ms": ms, "evaluations": ops.evaluations, **bnd,
            "exact_multiplets": len(exact), "exact_max_rel_err": exact_err,
            "max_grouping_err": float(errs.max()),
            "cell_split": geometry.n_split}


def dX_main_path_timing(wd: Path, state_fn, kernel, ops_of) -> dict:
    """The operation-0 kernel route on a main path's state, each launch
    timed by CUDA events: the summed kernel ms, the launches, the
    evaluations, the bound (``ops_of(slice operands)``: the operations of
    one launch) and the host wall of the whole route."""
    from is3d2_tpu_torch.core import spacetime
    cfg, state = main_path_state(wd, state_fn)
    ops = spacetime.kernel_operands(*state, cfg)
    events, work = [], {"evaluations": 0, "ops": 0.0, "bytes": 0}

    def timed(o, c):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = spacetime.run_kernel(o, c)
        end.record()
        events.append((start, end))
        work["evaluations"] += o.evaluations
        work["ops"] += ops_of(o)
        work["bytes"] += sum(a.numel() * a.element_size() for a in o.args()
                             if isinstance(a, torch.Tensor)) \
            + 8 * o.mom.shape[1]
        return out

    before = kernel.launches
    t0 = time.perf_counter()
    spacetime.kernel_bins(state[0], ops, *state[2:], cfg, timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = sum(a.elapsed_time(b) for a, b in events)
    ops_ms = work["ops"] / PEAK_FP32_OPS * 1e3
    bytes_ms = work["bytes"] / PEAK_BYTES * 1e3
    print(f"kernel route: {kernel.launches - before} launches, "
          f"{work['evaluations']:.4g} evaluations, kernel {ms:.1f} ms summed "
          f"({work['evaluations'] / ms * 1e3:.4g} evaluations/s), host wall "
          f"{wall * 1e3:.1f} ms; bound {max(ops_ms, bytes_ms):.1f} ms "
          f"({100 * max(ops_ms, bytes_ms) / ms:.1f} %)")
    return {"main_path_ms": ms, "main_path_launches": len(events),
            "main_path_evaluations": work["evaluations"],
            "main_path_wall_ms": wall * 1e3,
            "main_path_bound_ms": max(ops_ms, bytes_ms),
            "main_path_evaluations_per_s": work["evaluations"] / ms * 1e3,
            "state": (cfg, state, ops)}


def dX_bin_vs_plain(name, cfg, state, ops, tol, ops_of,
                    min_breakdown=0) -> dict:
    """The kernel and its plain version on the cells of the fullest tau bin
    (with at least ``min_breakdown`` breakdown cells, for B3), both timed;
    ``ops_of(operands)``: the operations of one launch, for the bound."""
    from is3d2_tpu_torch.core import spacetime
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    cells = state[0]
    idx, n = spacetime.bin_indices(cells, cfg)[0]
    rows, runs = spacetime.binned_cells(idx, n, cells.mask.cpu().numpy())
    sorted_ops = spacetime.cell_rows(ops, torch.as_tensor(rows,
                                                          device="cuda"))
    breaks = None if not hasattr(ops, "cols") else \
        (sorted_ops.cols[:, fk.BREAKS] != 0).cpu().numpy()
    best = None
    for b, begin, end in sorted(runs, key=lambda r: r[1] - r[2]):
        if breaks is None or breaks[begin:end].sum() >= min_breakdown:
            best = (b, begin, end)
            break
    if best is None:
        raise AssertionError(f"{name}: no bin holds a breakdown cell")
    b, begin, end = best
    one = spacetime.cell_rows(sorted_ops, slice(begin, end))
    n_break = 0 if breaks is None else int(breaks[begin:end].sum())
    ms, out = cuda_ms(lambda: spacetime.run_kernel(one, cfg))
    plain_ms, ref = cuda_ms(
        lambda: spacetime.run_kernel(one, cfg, plain=True),
        warmup=lambda: spacetime.run_kernel(
            spacetime.cell_rows(one, slice(0, 4)), cfg, plain=True))
    S = state[2].mass.shape[0]
    kern = out.reshape(S, -1).cpu().numpy()
    plain = ref.reshape(S, -1).cpu().numpy()
    rel = kc.max_rel_err(kern, plain)
    max_abs = float(np.abs(kc.spectra_units(state, out)
                           - kc.spectra_units(state, ref)).max())
    print(f"tau bin {b}: {end - begin} cells ({n_break} breakdown): kernel "
          f"{ms:.1f} ms, plain {plain_ms:.1f} ms; kernel vs plain {rel:.3e} "
          f"(bar {tol:g}), max |kernel - plain| {max_abs:.3e}")
    if not (np.isfinite(kern).all() and rel <= tol):
        raise AssertionError(f"{name} on one bin's cells disagrees with its "
                             "plain version")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs,
            **bound(ops_of(one), one.args(), one.mom.shape[1]),
            "cells_compared": end - begin, "breakdown_compared": n_break}


def dX_check(wd_parity: Path, cfg_fields: dict, surface_kw: dict) -> dict:
    """check_dX_case at 2,048 cells (the parity workdir's 16 species)."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.tools import kernel_check as kc
    cfg = Config(operation=0, cell_block=512, **cfg_fields)
    r = kc.check_dX_case(wd_parity, cfg, 2048, 7, "cuda", **surface_kw)
    print(f"2048 cells {json.dumps(cfg_fields)}: {r.launches} launches on "
          f"{r.bins} bins, {r.breakdown_cells} breakdown cells; kernel vs "
          f"plain {r.vs_plain:.3e} (bar {r.tol_plain:g}), kernel vs f64 "
          f"{r.vs_f64:.3e} (bar {r.tol_f64:g}), plain vs f64 "
          f"{r.plain_vs_f64:.3e}")
    feqmod = cfg.df_mode in (3, 4)
    if not (r.ok and r.launches == r.bins
            and (r.breakdown_cells > 0 or not feqmod)):
        raise AssertionError(f"operation 0 {cfg_fields}: the kernel route "
                             "is off its plain version or the f64 engine")
    return {"vs_plain": r.vs_plain, "vs_f64": r.vs_f64,
            "breakdown_cells": r.breakdown_cells}


def check_dX_files(wd: Path, wd_op1: Path | None) -> None:
    """The operation-0 files: three per species, finite, each axis summing
    to a positive yield (a bin of a few breakdown cells may be negative:
    the linearised delta-f is); with ``wd_op1`` (the same surface through
    operation 1), the tau axis summed back to dN/dy against its dN_dy
    files for pi+, K+ and p."""
    from is3d2_tpu_torch.config import Config
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    res = wd / "results/continuous"
    mcids = [int(v) for v in np.loadtxt(wd / "PDG/chosen_particles.dat")]
    for m in mcids:
        for name, n in (("dN_taudtaudy", cfg.tau_bins),
                        ("dN_2pirdrdy", cfg.r_bins),
                        ("dN_dphidy", cfg.phip_bins)):
            v = np.loadtxt(res / f"{name}_{m}.dat")
            if v.shape != (n, 2) or not np.isfinite(v).all() \
                    or not v[:, 1].sum() > 0:
                raise AssertionError(f"{name}_{m}: bad shape, value or sum")
    print(f"{3 * len(mcids)} files of {len(mcids)} species")
    if wd_op1 is None:
        return
    tau_w = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    for m in (211, 321, 2212):
        v = np.loadtxt(res / f"dN_taudtaudy_{m}.dat")
        total = float((v[:, 0] * v[:, 1]).sum() * tau_w)
        # summed over the y table: in 3+1d operation 0 sums it unweighted
        op1 = float(np.loadtxt(wd_op1 / f"results/continuous/dN_dy_{m}.dat",
                               ndmin=2)[:, 1].sum())
        print(f"{m}: sum over tau bins {total:.8g} vs op-1 dN/dy {op1:.8g} "
              f"({(total - op1) / op1:+.2e})")
        if abs(total - op1) > 1e-5 * op1:
            raise AssertionError(f"{m}: the tau bins do not sum to dN/dy")


def dX_cells_timing(wd: Path) -> dict:
    """B1's per-cell route (spacetime.comp_cell_bins) on the df-1 main
    path's state as the driver runs it: the whole route timed by CUDA
    events and the host's clock, its launches; the per-cell kernel alone
    on the route's operands (the cells some axis binned), twice for equal
    bits, against its bound (B1's operations an evaluation; bytes: the
    operands and the (C, S) f64 result); and the wrapper held to its plain
    version on the first B1_CELLS_COMPARE_CELLS of those cells (per (cell,
    species), in units of the cell's sum of |terms|), both timed there."""
    from is3d2_tpu_torch.core import spacetime
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.tools import kernel_check as kc
    cfg, state = main_path_state(wd, kc.engine_state)

    def route():
        return spacetime.comp_cell_bins(*state, cfg)
    route()
    before = ck.cooper_frye_comp_cells.launches
    t0 = time.perf_counter()
    route_ms, _ = cuda_ms(route, warmup=lambda: None)
    wall = time.perf_counter() - t0
    launches = ck.cooper_frye_comp_cells.launches - before

    kept, args = kc.cells_operands(
        state, spacetime.kernel_operands(*state, cfg), cfg)
    kernel = functools.partial(ck.cooper_frye_comp_cells,
                               row_len=kept.row_len)
    first = kernel(*args)
    ms, second = cuda_ms(lambda: kernel(*args), warmup=lambda: None)
    if not torch.equal(first, second):
        raise AssertionError("two launches of B1's per-cell mode on the main "
                             "path's operands gave different bits")
    C, S = first.shape
    del first, second
    # bound()'s output is n_mom f64 values: here the (C, S) result
    main_bound = bound(BOUND_OPS_PER_EVALUATION["cooper_frye_comp"]
                       * kept.evaluations, args, C * S)
    print(f"per-cell route: {launches} launch(es), {ms:.1f} ms in the kernel "
          f"of {route_ms:.1f} ms on the device, host wall {wall * 1e3:.1f} "
          f"ms; {C} cells x {kept.eta.shape[0]} eta x {kept.mom.shape[1]} "
          f"momenta = {kept.evaluations:.4g} evaluations "
          f"({kept.evaluations / ms * 1e3:.4g} evaluations/s); two launches "
          f"gave equal bits; bound {main_bound['bound_ms']:.1f} ms "
          f"({100 * main_bound['bound_ms'] / ms:.1f} %) "
          f"{ck.cooper_frye_comp_cells.last_geometry}")

    n = min(B1_CELLS_COMPARE_CELLS, C)

    def cut(k):
        return (kept.cell[:k].contiguous(), kept.qm[:k].contiguous(),
                *args[2:])
    cut_ms, out = cuda_ms(lambda: kernel(*cut(n)))
    plain_ms, ref = cuda_ms(
        lambda: ck.cooper_frye_comp_cells_plain(*cut(n)),
        warmup=lambda: ck.cooper_frye_comp_cells_plain(*cut(64)))
    out = out.cpu().numpy()
    err = kc.max_scaled_err(out, ref.cpu().numpy(), kc.cells_scale(*cut(n)))
    print(f"first {n} cells: kernel {cut_ms:.1f} ms, plain version "
          f"{plain_ms:.1f} ms; kernel vs plain {err:.3e} of the cells' "
          f"|terms| (bar {kc.TOL:g})")
    if not (np.isfinite(out).all() and err <= kc.TOL):
        raise AssertionError("B1's per-cell mode disagrees with its plain "
                             f"version on the main path's cells ({err:.3e})")
    return {"route_ms": route_ms, "route_wall_ms": wall * 1e3,
            "main_path_launches": launches, "main_path_ms": ms,
            "main_path_evaluations": kept.evaluations,
            "main_path_bound_ms": main_bound["bound_ms"],
            "main_path_share_of_bound": main_bound["bound_ms"] / ms,
            "main_path_evaluations_per_s": kept.evaluations / ms * 1e3,
            "ms": cut_ms, "plain_ms": plain_ms, "vs_plain": err,
            "cells_compared": n}


def dX_cells_check(wd_parity: Path, cfg_fields: dict) -> dict:
    """check_dX_cells_case at 2,048 cells (the parity workdir's 16
    species)."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.tools import kernel_check as kc
    cfg = Config(operation=0, cell_block=512, **cfg_fields)
    r = kc.check_dX_cells_case(wd_parity, cfg, 2048, 7, "cuda")
    print(f"2048 cells {json.dumps(cfg_fields)}, per-cell route: "
          f"{r.launches} launch(es); kernel vs plain {r.vs_plain:.3e} of the "
          f"cells' |terms| (bar {kc.TOL:g}), bins vs the per-bin route "
          f"{r.vs_per_bin:.3e} (bar {kc.CELLS_TOL_PER_BIN:g}), vs f64 "
          f"{r.vs_f64:.3e} (bar {kc.TOL:g}), repeats {r.repeats}")
    if not (r.ok and r.launches == 1):
        raise AssertionError(f"operation 0 {cfg_fields}: the per-cell route "
                             "is off its plain version, the per-bin route "
                             "or the f64 engine, or moved between runs")
    return {"vs_plain": r.vs_plain, "vs_per_bin": r.vs_per_bin,
            "vs_f64": r.vs_f64}


def phase_op0_b1(tmp: Path, wd1: Path, wd_parity: Path) -> dict:
    print(f"== 18. operation 0, df 1, f32c: phase 5's {MAIN_CELLS} cells, all "
          "species, 51 x 48 x 24, through B1's per-cell mode (and B1 on "
          "every bin, the meshed route's)")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.tools import kernel_check as kc
    wd = derived_workdir(tmp, wd1, "op0_df1", {"operation": 0})
    launches, stages, _ = run_cli(wd, "cooper_frye_comp_cells")
    launches = launches["cooper_frye_comp_cells"]
    print(f"stage seconds: {json.dumps(stages)}")
    check_dX_files(wd, wd1)
    cells = dX_cells_timing(wd)
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_comp"]

    def b1_ops(o):
        return per_eval * o.evaluations

    t = dX_main_path_timing(wd, kc.engine_state, ck.cooper_frye_comp, b1_ops)
    cfg, state, ops = t.pop("state")
    cmp = dX_bin_vs_plain("B1", cfg, state, ops, kc.TOL, b1_ops)
    fields = {"df_mode": 1, "compute_dtype": "f32c"}
    return {"launches": launches, "stage_seconds": stages, **cells,
            "library_ms": None,
            "at_2048_cells": dX_cells_check(wd_parity, fields),
            "per_bin_route": {**t, **cmp,
                              "at_2048_cells": dX_check(wd_parity, fields,
                                                        {})}}


def phase_op0_b3(tmp: Path, wd_parity: Path) -> dict:
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    print(f"== 19. operation 0, df 4, f32: {MAIN_CELLS} cells written in "
          f"mode 6 with dsigma_eta / tau in +-{kc.DX_DAN}, shear 0.2, bulk "
          "0.1, all species, 51 x 48 x 24 (not folded), through B3 "
          "(dan-weighted) on every bin")
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    t0 = time.perf_counter()
    wd = write_workdir(tmp / "op0_df4", n_cells=MAIN_CELLS,
                       params={"operation": 0, "df_mode": 4,
                               "compute_dtype": "f32"},
                       surface_mode=6, dan_scale=kc.DX_DAN,
                       **kc.FEQMOD_SURFACE)
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, out = run_cli(wd, "cooper_frye_feqmod")
    launches = launches["cooper_frye_feqmod"]
    n_break = int(re.search(r"^feqmod breaks down for (\d+) /", out,
                            re.M).group(1))
    print(f"stage seconds: {json.dumps(stages)}; {n_break} breakdown cells")
    check_dX_files(wd, None)
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod"]

    def b3_ops(o):
        n_b = int((o.cols[:, fk.BREAKS] != 0).sum().item())
        per_cell = o.evaluations / o.cols.shape[0]
        return per_cell * (n_b * per_eval["breakdown"]
                           + (o.cols.shape[0] - n_b) * per_eval["modified"])

    t = dX_main_path_timing(wd, kc.feqmod_engine_state, fk.cooper_frye_feqmod,
                            b3_ops)
    cfg, state, ops = t.pop("state")
    if not ops.dan_weighted or ops.eta.shape[0] != 24:
        raise AssertionError("B3's operation-0 operands are not dan-weighted "
                             "on the unfolded 24 nodes")
    cmp = dX_bin_vs_plain("B3", cfg, state, ops, kc.FEQMOD_TOL_PLAIN, b3_ops,
                          min_breakdown=1)
    small = {name: dX_check(wd_parity, fields, kc.FEQMOD_SURFACE)
             for name, fields in (
                 ("df4", {"df_mode": 4, "compute_dtype": "f32"}),
                 ("df3-outflow", {"df_mode": 3, "compute_dtype": "f32",
                                  "outflow": 1}))}
    return {"launches": launches, "stage_seconds": stages,
            "breakdown_cells": n_break, **t, **cmp, "library_ms": None,
            "at_2048_cells": small}


def phase_p1_compare(wd: Path, wd_eta: Path) -> None:
    print("== 20. P1, both instantiations, vs plain version vs f64 "
          "polarization engine (2048 cells, 16 species, 51 x 48, 24 eta; "
          "vorticity)")
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    from is3d2_tpu_torch.tools import kernel_check as kc

    def chunks(n):
        return -(-n // pz.ETA_CHUNK)

    def case(workdir, **kw):
        return kc.check_polarization_case(workdir, 2048, 7, "cuda",
                                          cell_block=512, **kw)

    n = kc.ETA_NODES
    # name -> (result, instantiation folded, launches)
    cases = {
        "24 eta, folded": (case(wd), True, 1),
        "24 eta, general": (case(wd, eta_fold=0), False, 1),
        "24 eta, general, un": (case(wd, un_scale=0.05), False, 1),
        f"{n} eta, folded": (case(wd_eta), True, chunks(n // 2)),
        f"{n} eta, general": (case(wd_eta, eta_fold=0), False, chunks(n)),
        "ragged, folded": (
            kc.check_polarization_ragged_case(wd, 2048, 7, "cuda"), True, 1),
        "ragged, general": (kc.check_polarization_ragged_case(
            wd, 2048, 7, "cuda", eta_fold=0), False, 1)}
    for name, (r, folded, launches) in cases.items():
        print(f"{name:22s} ({r.launches} launches) kernel vs plain: Snorm "
              f"{r.vs_plain[0]:.3e}, P {r.vs_plain[1]:.3e}; kernel vs f64: "
              f"Snorm {r.vs_f64[0]:.3e}, P {r.vs_f64[1]:.3e}; plain vs f64: "
              f"Snorm {r.plain_vs_f64[0]:.3e}, P {r.plain_vs_f64[1]:.3e}")
        if not (r.ok and r.launches == launches and r.folded == folded):
            raise AssertionError(
                f"P1 {name}: kernel disagrees, does not repeat, launched "
                f"{r.launches} times, not {launches}, or folded is "
                f"{r.folded} ({r.vs_plain} vs plain, {r.vs_f64} vs f64; "
                f"bars {kc.POLZN_TOL_PLAIN:g} plain, {kc.POLZN_TOL_NORM:g} "
                f"/ {kc.POLZN_TOL_P:g} f64)")


def phase_p1_main_path(tmp: Path) -> tuple[dict, dict, Path]:
    print(f"== 21. mode-5 main path: {MAIN_CELLS} cells with thermal "
          "vorticity, all species, 51 x 48 x 24, df 1, f32c: the spectra "
          "on B1, the polarization on P1 (folded: 12 nodes)")
    from is3d2_tpu_torch.io.fastio import load_table_fast
    from is3d2_tpu_torch.io.output import POLARIZATION_FILES
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    launches, stages, wd, _ = run_main_path(
        tmp, "main_mode5", "cooper_frye_comp",
        {"df_mode": 1, "compute_dtype": "f32c"}, also=("polarization_f32",),
        surface_mode=5)
    last = pz.polarization_f32.last_launch
    print(f"P1's launch: {json.dumps(last)}")
    if not (launches["polarization_f32"] == 1 and last["folded"]
            and last["eta"] == 12 and last["cells"] == MAIN_CELLS):
        raise AssertionError("the mode-5 main path did not launch P1 once, "
                             f"folded, on 12 nodes and {MAIN_CELLS} cells")
    n_species = len(np.loadtxt(wd / "PDG/chosen_particles.dat"))
    rows = n_species * 48 * 51
    t0 = time.perf_counter()
    for name in POLARIZATION_FILES:
        v = load_table_fast(wd / f"results/{name}.dat")
        if v.shape != (rows, 4) or not np.isfinite(v).all():
            raise AssertionError(f"{name}.dat: shape {v.shape} (want "
                                 f"({rows}, 4)) or a value not finite")
        print(f"{name}.dat: {v.shape[0]} rows, finite, max |P| "
              f"{np.abs(v[:, 3]).max():.4e}")
    print(f"(parsed in {time.perf_counter() - t0:.1f} s); kernel launches "
          f"{json.dumps(launches)}; stage seconds: {json.dumps(stages)}")
    return launches, stages, wd


def sm_clocks() -> tuple[int, int]:
    """(clocks.sm, clocks.max.sm) of card 0, in MHz."""
    line = sh("nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
              "--format=csv,noheader,nounits").splitlines()[0]
    now, peak = (int(v) for v in line.split(","))
    return now, peak


def timed_3d(kernel, args, evaluations: int, check=None) -> dict:
    """A 3+1d mode at full size: one launch, then one between samples of
    the SM clock timed by CUDA events; the two must give equal bits.
    ``check`` (optional) is called on the first launch's result."""
    first = kernel(*args)
    if check is not None:
        check(first)
    torch.cuda.synchronize()
    before, clock_max = sm_clocks()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    second = kernel(*args)
    end.record()
    during, _ = sm_clocks()      # the kernel runs while this is read
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    after, _ = sm_clocks()
    print(f"kernel at full size {ms:.1f} ms, {evaluations / ms * 1e3:.4g} "
          f"evaluations/s; clocks.sm {before} MHz before, {during} MHz "
          f"during, {after} MHz after (clocks.max.sm {clock_max} MHz)")
    if not torch.equal(first, second):
        raise AssertionError("two launches on the main path's operands gave "
                             "different bits")
    print("two launches at full size gave equal bits")
    return {"main_path_ms": ms,
            "main_path_evaluations_per_s": evaluations / ms * 1e3,
            "main_path_evaluations": evaluations,
            "clocks_sm_mhz": {"before": before, "during": during,
                              "after": after, "max": clock_max}}


# special-function lanes of one H100 SM (MUFU: EX2, RCP; the f32 -> f64
# conversions take the same narrow pipe)
SFU_LANES_PER_SM = 16


def p1_timed(which: str, ops, sass: dict) -> dict:
    """Phase 22 for one instantiation: P1 at full size on ``ops`` between
    samples of the SM clock, then against its plain version on the first
    P1_COMPARE_CELLS cells.  The full-size sums go back under "sums"."""
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    from is3d2_tpu_torch.tools import kernel_check as kc

    args = ops.args()
    kernel = functools.partial(pz.polarization_f32, row_len=ops.row_len)
    C, Ne, M = ops.cell.shape[0], ops.eta.shape[0], ops.mom.shape[1]
    print(f"-- {which}: {C} real cells x {Ne} eta x {M} momenta (M mod 256 "
          f"= {M % 256}) = {ops.evaluations:.4g} evaluations")
    first = kernel(*args)
    torch.cuda.synchronize()
    before, clock_max = sm_clocks()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    second = kernel(*args)
    end.record()
    during, _ = sm_clocks()      # the kernel runs while this is read
    torch.cuda.synchronize()
    full_ms = start.elapsed_time(end)
    after, _ = sm_clocks()
    print(f"kernel at full size {full_ms:.1f} ms, "
          f"{ops.evaluations / full_ms * 1e3:.4g} evaluations/s; clocks.sm "
          f"{before} MHz before, {during} MHz during, {after} MHz after "
          f"(clocks.max.sm {clock_max} MHz)")
    if not torch.equal(first, second):
        raise AssertionError(f"two launches of P1 ({which}) on the main "
                             "path's operands gave different bits")
    print("two launches at full size gave equal bits")
    if not (torch.isfinite(first).all() and (first[4] > 0).all()):
        raise AssertionError(f"P1 ({which}) at full size: a sum not finite "
                             "or an Snorm <= 0")
    print(f"every sum finite, Snorm > 0 on all {M} momenta")
    sums = first.cpu().numpy()
    del first, second
    g = pz.polarization_f32.last_geometry
    print(f"launched with {g}")
    per_eval = BOUND_OPS_PER_EVALUATION["polarization_f32"][which]

    def cut(n):
        return (ops.cell[:n].contiguous(), *args[1:])

    n = P1_COMPARE_CELLS
    print(f"compared on the first {n} cells at the full M")
    ms, out = cuda_ms(lambda: kernel(*cut(n)))
    plain_ms, ref = cuda_ms(lambda: pz.polarization_f32_plain(*cut(n)),
                            warmup=lambda: pz.polarization_f32_plain(*cut(64)))
    print(f"cut: kernel {ms:.1f} ms, plain version {plain_ms:.1f} ms "
          f"({plain_ms / ms:.1f}x the kernel)")
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    norm_err, p_err = kc.polarization_errors(out, ref)
    max_abs = kc.polarization_units(out, ref)
    print(f"kernel vs plain: Snorm {norm_err:.3e} relative, P {p_err:.3e} of "
          f"max |P| (bar {kc.POLZN_TOL_PLAIN:g}), max |P_kernel - P_plain| "
          f"{max_abs:.3e}")
    if not (np.isfinite(out).all() and max(norm_err, p_err)
            <= kc.POLZN_TOL_PLAIN):
        raise AssertionError(f"P1 ({which}) disagrees with its plain version "
                             "on the main path's operands")
    main_bound = bound(per_eval * ops.evaluations, args, 5 * M)["bound_ms"]
    mufu = sass["eta_loop_per_evaluation"]["mufu"] * ops.evaluations
    sfu_floor = mufu / (SFU_LANES_PER_SM * H100_SMS * clock_max * 1e6) * 1e3
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / full_ms:.1f} % of it; sfu_floor_ms "
          f"{sfu_floor:.1f} ({mufu:.4g} MUFU operations over "
          f"{SFU_LANES_PER_SM} x {H100_SMS} lanes at {clock_max} MHz): "
          f"{100 * sfu_floor / full_ms:.1f} % of it")
    return {"register_tile": g.r, "cell_split": g.n_split,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(per_eval * n * Ne * M, cut(n), 5 * M),
            "main_path_bound_ms": main_bound,
            "main_path_evaluations_per_s": ops.evaluations / full_ms * 1e3,
            "main_path_share_of_bound": main_bound / full_ms,
            "sfu_floor_ms": sfu_floor,
            "main_path_share_of_sfu_floor": sfu_floor / full_ms,
            "clocks_sm_mhz": {"before": before, "during": during,
                              "after": after, "max": clock_max},
            # no single PyTorch call computes a polarization sum
            "library_ms": None,
            "cells_compared": n, "snorm_rel_err": norm_err,
            "p_err": p_err, "main_path_ms": full_ms,
            "main_path_evaluations": ops.evaluations,
            "eta_nodes": Ne, "sums": sums}


def phase_p1_full(wd: Path, sass: dict) -> dict:
    print("== 22. P1 on the mode-5 main path's operands, folded and general")
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.polarization_engine_state)
    runs = {}
    for which, eta_fold in (("folded", cfg.eta_fold), ("general", 0)):
        ops = kc.polarization_operands(
            state, dataclasses.replace(cfg, eta_fold=eta_fold))
        if ops.folded != (which == "folded"):
            raise AssertionError(f"the fold gate did not pick {which}")
        runs[which] = p1_timed(which, ops, sass[which])
        del ops
    norm, p = kc.polarization_errors(runs["folded"].pop("sums"),
                                     runs["general"].pop("sums"))
    print(f"folded vs general at full size: Snorm {norm:.3e}, P {p:.3e} "
          f"(bars {kc.POLZN_TOL_NORM:g} / {kc.POLZN_TOL_P:g})")
    if not (norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P):
        raise AssertionError("P1 folded and general disagree at full size")
    general = runs["general"]
    print(f"folded {runs['folded']['main_path_ms']:.1f} ms against general "
          f"{general['main_path_ms']:.1f} ms "
          f"({general['main_path_ms'] / runs['folded']['main_path_ms']:.2f}x)")
    return {**runs["folded"], "general": general,
            "folded_vs_general": {"snorm_rel_err": norm, "p_err": p}}


def parity_workdir_3d(tmp: Path) -> Path:
    """Phase 3's parity workdir in 3+1d: its 16 species and 51 x 48 grid,
    and the 21-point y table over |y| <= 5."""
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    return write_workdir(tmp / "compare_3d", n_cells=16,
                         chosen_mcids=PARITY_CHOSEN, include_baryon=True,
                         n_muB=9, dimension=3)


def phase_b1_3d_compare(wd: Path) -> None:
    print("== 23. B1's 3+1d mode vs plain version vs f64 engine (2048 cells "
          "of a 3+1d surface, 16 species, 51 x 48 x 21 y)")
    from is3d2_tpu_torch.tools import kernel_check as kc
    cases = {f"{name} f32c": kc.check_3d_case(wd, name, 2048, 7, "cuda")
             for name in kc.CASES}
    for name in ("df1", "df2"):
        r = kc.check_3d_case(wd, name, 2048, 7, "cuda", compute_dtype="f32")
        if not np.array_equal(r.kernel, cases[f"{name} f32c"].kernel):
            raise AssertionError(f"3+1d {name}: f32 and f32c differ")
        cases[f"{name} f32"] = r
    for n_y in kc.RAGGED_Y:
        cases[f"ragged {json.dumps(kc.RAGGED)} x {n_y} y"] = \
            kc.check_3d_ragged_case(wd, 2048, 7, "cuda", n_y=n_y)
    for name, r in cases.items():
        print(f"{name:26s} kernel vs plain {r.vs_plain:.3e}; kernel vs f64 "
              f"{r.vs_f64_global:.3e} (bins of the largest peak; "
              f"{r.vs_f64:.3e} of each species' peak); plain vs f64 "
              f"{r.plain_vs_f64:.3e}; of each peak: kernel vs plain "
              f"{kc.peak_err(r.kernel, r.plain):.3e}, vs f64 "
              f"{kc.peak_err(r.kernel, r.f64):.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"3+1d {name}: kernel disagrees or does "
                                 f"not repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64_global:.3e} vs f64)")


def phase_b1_3d_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 24. 3+1d df-1 main path: {MAIN_CELLS} cells of a 3+1d "
          "surface, all species, 51 x 48 x 21 y, f32c")
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    t0 = time.perf_counter()
    wd = write_workdir(tmp / "main_3d", n_cells=MAIN_CELLS, dimension=3,
                       params={"df_mode": 1, "compute_dtype": "f32c"})
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, _ = run_cli(wd, "cooper_frye_comp_3d")
    print(f"stage seconds: {json.dumps(stages)}")
    check_3d_spectra_files(wd)
    return launches["cooper_frye_comp_3d"], stages, wd


def check_3d_spectra_files(wd: Path) -> None:
    """A 3+1d operation-1 run's files: S x NpT x Nphi x Ny rows, finite,
    dN/dy pi+ > K+ > p > 0 at every |y| <= 3 of the table and pi+ > 0 at
    every y."""
    from is3d2_tpu_torch.io.tables import MomentumGrids
    g = MomentumGrids.from_dir(wd / "tables")
    rows = len(g.pT) * len(g.phi) * len(g.y)
    res = wd / "results/continuous"
    mcids = [int(v) for v in np.loadtxt(wd / "PDG/chosen_particles.dat")]
    t0 = time.perf_counter()
    negative = 0
    for m in (211, 321, 2212, mcids[-1]):
        v = np.loadtxt(res / f"dN_pTdpTdphidy_{m}.dat", skiprows=1)
        if v.shape != (rows, 4) or not np.isfinite(v).all():
            raise AssertionError(f"3+1d spectra of {m}: shape {v.shape} or "
                                 "a value not finite")
        negative += int((v[:, 3] < 0).sum())
    print(f"dN_pTdpTdphidy files of pi+, K+, p and {mcids[-1]}: {rows} "
          f"rows each, finite, {negative} bins below zero (parsed in "
          f"{time.perf_counter() - t0:.1f} s); {len(mcids)} species")
    dndy = {m: np.loadtxt(res / f"dN_dy_{m}.dat") for m in (211, 321, 2212)}
    print("dN/dy at y = " + ", ".join(
        f"{y:g}: pi+ {a:.6g} K+ {b:.6g} p {c:.6g}" for y, a, b, c in zip(
            dndy[211][::5, 0], dndy[211][::5, 1], dndy[321][::5, 1],
            dndy[2212][::5, 1])))
    # at |y| = 5, 3 units beyond the cells' eta, K+ and p print as 0 in
    # the files' 8 decimals
    inner = np.abs(g.y) <= 3.0
    if not (np.array_equal(dndy[211][:, 0], np.round(g.y, 8))
            and (dndy[211][:, 1] > 0).all() and (
            (dndy[211][inner, 1] > dndy[321][inner, 1])
            & (dndy[321][inner, 1] > dndy[2212][inner, 1])
            & (dndy[2212][inner, 1] > 0)).all()):
        raise AssertionError("3+1d dN/dy is not ordered pi+ > K+ > p > 0 "
                             "at every |y| <= 3 of the table, or pi+ not "
                             "positive at every y")


def phase_b1_3d_full(wd: Path, sass: dict) -> dict:
    print("== 24. (cont.) B1's 3+1d mode on the main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops.spectra_fast_common import comp_operands_3d
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.engine_state)
    ops = comp_operands_3d(*state, cfg)
    kernel = functools.partial(ck.cooper_frye_comp_3d, **ops.layout())
    args = (*ops.args(), cfg)
    C, M = ops.cell.shape[0], ops.mom.shape[1]
    print(f"{C} live cells x {M} momenta (M mod 256 = {M % 256}) = "
          f"{ops.evaluations:.4g} evaluations")
    r = timed_3d(kernel, args, ops.evaluations)
    full_ms, clock_max = r["main_path_ms"], r["clocks_sm_mhz"]["max"]
    g = ck.cooper_frye_comp_3d.last_geometry
    print(f"launched with {g}")
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_comp_3d"]

    def cut(n):
        return (ops.cell[:n].contiguous(), ops.mom, cfg)

    n = B1_3D_COMPARE_CELLS
    print(f"compared on the first {n} live cells at the full M")
    ms, plain_ms, max_abs = compare_on_cut(
        kernel, ck.cooper_frye_comp_3d_plain, cut(64), cut(n),
        lambda flat: kc.spectra_units(state, flat), kc.TOL, "B1 3+1d")
    main_bound = bound(per_eval * ops.evaluations, args, M)["bound_ms"]
    floor = fp32_issue_floor_ms(sass["fp32"], ops.evaluations, clock_max)
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / full_ms:.1f} % of it; fp32_issue_floor_ms "
          f"{floor:.1f} ({sass['fp32']:.2f} FP32 instructions an evaluation "
          f"over {FP32_LANES_PER_SM} x {H100_SMS} lanes at {clock_max} MHz):"
          f" {100 * floor / full_ms:.1f} % of it")
    return {"register_tile": g.r, "register_tile_y": g.ty,
            "threads": g.threads, "cell_split": g.n_split,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(per_eval * n * M, cut(n), M),
            "main_path_bound_ms": main_bound,
            "main_path_share_of_bound": main_bound / full_ms,
            "fp32_per_evaluation": sass["fp32"],
            "fp32_issue_floor_ms": floor,
            "main_path_share_of_fp32_floor": floor / full_ms, **r,
            # no single PyTorch call computes a Cooper-Frye sum
            "library_ms": None, "cells_compared": n}


def phase_op0_3d(tmp: Path, wd3: Path) -> dict:
    print(f"== 25. operation 0 in 3+1d: phase 24's surface cut to its first "
          f"{OP0_3D_CELLS} cells, all species, 51 x 48 x 21 y, through the "
          "f64 engine")
    from is3d2_tpu_torch.core.spectra import compute_spectra
    from is3d2_tpu_torch.driver import IS3D
    wd = derived_workdir(tmp, wd3, "op0_3d", {"operation": 0})
    surface = wd / "input/surface.dat"
    with open(surface) as fh:
        head = [next(fh) for _ in range(OP0_3D_CELLS)]
    surface.write_text("".join(head))
    launches, stages, _ = run_cli(wd, None)
    print(f"stage seconds: {json.dumps(stages)}; {OP0_3D_CELLS} cells: "
          f"{stages['compute'] / OP0_3D_CELLS * 1e3:.2f} ms of compute a cell")
    check_dX_files(wd, None)
    # the same cells through B1's 3+1d mode (operation 1, f32c), summed over
    # the y table as operation 0 sums it
    run = IS3D(wd, device="cuda")
    run.load_surface_from_file()
    run._setup()
    cfg = dataclasses.replace(run.cfg, operation=1)
    spectra = compute_spectra(run.surface, run.species, run.chosen_idx,
                              run.grids, run.df_data, cfg, "cuda")
    g = run.grids
    op1 = np.einsum("p,f,spfy->s", g.pT_weight, g.phi_weight, spectra)
    mcids = [int(run.species.mc_id[i]) for i in run.chosen_idx]
    res = wd / "results/continuous"
    tau_w = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    errs = {}
    for m in (211, 321, 2212):
        v = np.loadtxt(res / f"dN_taudtaudy_{m}.dat")
        total = float((v[:, 0] * v[:, 1]).sum() * tau_w)
        ref = float(op1[mcids.index(m)])
        errs[str(m)] = (total - ref) / ref
        print(f"{m}: sum over tau bins {total:.8g} vs B1's 3+1d mode "
              f"summed over y {ref:.8g} ({errs[str(m)]:+.2e})")
    if max(abs(e) for e in errs.values()) > 1e-5:
        raise AssertionError("3+1d operation 0 does not sum to B1's dN/dy")
    return {"cells": OP0_3D_CELLS, "stage_seconds": stages,
            "compute_ms_per_cell": stages["compute"] / OP0_3D_CELLS * 1e3,
            "vs_b1_3d": errs}


def phase_sampler_3d(tmp: Path, wd3: Path) -> dict:
    print(f"== 26. op-2 histograms in 3+1d: phase 24's {MAIN_CELLS} cells, "
          "all species, df 1, test_sampler 1, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd3, "op2_3d", {
        "operation": 2, "test_sampler": 1, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    r["closure"] = closure_3d(wd, wd3, r["n_events"])
    print("-- OSCAR event files, df 2, min_num_hadrons 1e6")
    wd = derived_workdir(tmp, wd3, "op2_3d_oscar", {
        "operation": 2, "df_mode": 2, "test_sampler": 0, "fast": 1,
        "min_num_hadrons": 1.0e6, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    oscar = run_op2(wd)
    oscar["oscar_rows"] = check_oscar_files(wd, oscar)
    r["oscar_df2"] = oscar
    return r


def closure_3d(wd: Path, wd_op1: Path, n_events: int) -> dict:
    """The sampled dN/dy of a 3+1d operation-2 run against the op-1 dN/dy
    files of the same surface: pi+ and K+ in every bin at |y| < 1 within
    5 sigma + 3 % (the JAX package's 3+1d closure bar; p printed)."""
    closure = {}
    for m in (211, 321, 2212):
        hist = np.loadtxt(wd / f"results/sampled/dN_dy/dN_dy_{m}_test.dat")
        smooth = np.loadtxt(wd_op1 / f"results/continuous/dN_dy_{m}.dat")
        y_mid, obs = hist[:, 0], hist[:, 1]
        sel = np.abs(y_mid) < 1.0
        y_w = y_mid[1] - y_mid[0]
        counts = obs[sel] * y_w * n_events
        sigma = np.sqrt(np.maximum(counts, 1.0)) / (y_w * n_events)
        ref = np.interp(y_mid[sel], smooth[:, 0], smooth[:, 1])
        dev = (obs[sel] - ref) / ref
        ok = bool((np.abs(obs[sel] - ref) < 5.0 * sigma + 0.03 * ref).all())
        closure[str(m)] = {"counts": float(counts.sum()),
                           "max_rel_dev": float(np.abs(dev).max()),
                           "mean_rel_dev": float(dev.mean()), "ok": ok}
        print(f"dN/dy {m} at |y| < 1 ({counts.sum():.0f} hadrons in "
              f"{sel.sum()} bins): sampled vs op-1 mean {dev.mean():+.3e}, "
              f"worst {np.abs(dev).max():.3e}; within 5 sigma + 3 %: {ok}")
    if not (closure["211"]["ok"] and closure["321"]["ok"]):
        raise AssertionError("3+1d dN/dy closure of pi+ or K+ fails")
    return closure


# ----------------------------------------------------------------------
# phases 27-29: the multi-surface ensemble (core/ensemble.py)
# ----------------------------------------------------------------------

# the JAX package's ensemble record, scripts/northstar.py:180-191: 64
# surfaces make_surface(4096, seed=1000 + i, shear 0.03, bulk 0.015), df 1,
# cell_block 4096, surface_chunk 16; 10 events a surface at y_cut 3, seed 5
ENSEMBLE_SURFACES = 64
ENSEMBLE_CELLS = 4096
ENSEMBLE_SEED0 = 1000
ENSEMBLE_CHUNK = 16
ENSEMBLE_SURFACE = {"shear_scale": 0.03, "bulk_scale": 0.015}
ENSEMBLE_EVENTS = 10
ENSEMBLE_SAMPLER_SEED = 5


@contextlib.contextmanager
def timed_launches():
    """A CUDA event before and after every launch of B1 (its three modes),
    B2 and B3 while the block runs: yields the list of (kernel, start, end)
    it fills.  The wrappers call their module's launch functions by name,
    so wrapping those times each launch and nothing else."""
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops import cooper_frye_f32 as b2
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    spans = []
    targets = [(ck, "launch", "cooper_frye_comp"),
               (ck, "launch_3d", "cooper_frye_comp_3d"),
               (ck, "launch_cells", "cooper_frye_comp_cells"),
               (b2, "launch", "cooper_frye_f32"),
               (fk, "launch", "cooper_frye_feqmod"),
               (fk, "launch_3d_split", "cooper_frye_feqmod_3d")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def timed(name, fn):
        def run(*args, **kw):
            # on the stream of the launch's own card (a mesh launches on
            # several): every wrapped launch takes its operand first
            dev = args[0].device
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
            spans.append((name, start, end, dev))
            return out
        return run

    for (mod, attr, fn), (_, _, name) in zip(saved, targets):
        setattr(mod, attr, timed(name, fn))
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def span_stats(spans, wall_s: float) -> dict:
    """Kernel ms summed over ``spans``, the busy share of ``wall_s``, and
    the device's gaps between one launch's end and the next one's start
    (where both ran on one card)."""
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)
    ms = [s.elapsed_time(e) for _, s, e, _ in spans]
    gaps = [spans[k][2].elapsed_time(spans[k + 1][1])
            for k in range(len(spans) - 1) if spans[k][3] == spans[k + 1][3]]
    return {"wall_s": wall_s, "launches": len(spans),
            "kernel_ms": float(sum(ms)),
            "kernel_ms_each": {"min": float(min(ms)), "max": float(max(ms)),
                               "median": float(np.median(ms))},
            "busy_share": float(sum(ms)) / (wall_s * 1e3),
            "gap_ms": {"median": float(np.median(gaps)) if gaps else 0.0,
                       "max": float(max(gaps)) if gaps else 0.0}}


def ensemble_inputs(wd: Path, df_mode: int, plasma_surface):
    """The species (all of them chosen), grids, Gauss-Laguerre table and
    delta-f data of a workdir, as the driver builds them (the Jonah splines
    at ``plasma_surface``'s averages)."""
    from is3d2_tpu_torch.io.deltaf_tables import DeltafTables
    from is3d2_tpu_torch.io.pdg import read_pdg
    from is3d2_tpu_torch.io.tables import (GaussLaguerre, MomentumGrids,
                                           load_table)
    from is3d2_tpu_torch.physics.deltaf import DeltafData
    species = read_pdg(3, wd / "PDG")
    chosen = species.chosen_indices(load_table(
        wd / "PDG/chosen_particles.dat")[:, 0].astype(int))
    laguerre = GaussLaguerre.from_file(
        wd / "tables/gauss/gla_roots_weights.txt")
    df_data = DeltafData(DeltafTables.load(3, False,
                                           wd / "deltaf_coefficients/vh"),
                         df_mode, False)
    df_data.compute_jonah_coefficients(species, laguerre,
                                       plasma_surface.thermo_averages())
    return species, chosen, MomentumGrids.from_dir(wd / "tables"), \
        laguerre, df_data


def counted(fn, kernel: str | None, n: int):
    """fn() with every launch count set to 0 just before and read just
    after: ``kernel`` must launch ``n`` times and no other kernel (with
    ``kernel`` None, none).  Returns (fn's result, launches, wall s)."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    want = {name: (n if name == kernel else 0) for name in counters}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return out, launches, wall


def phase_ensemble_spectra(wd1: Path) -> dict:
    print(f"== 27. ensemble spectra: {ENSEMBLE_SURFACES} surfaces x "
          f"{ENSEMBLE_CELLS} cells, all species, 51 x 48 x 24, df 1, f32c "
          f"(B1), cell_block {ENSEMBLE_CELLS}, surface_chunk "
          f"{ENSEMBLE_CHUNK}")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.core.ensemble import compute_spectra_ensemble
    from is3d2_tpu_torch.core.spectra import compute_spectra, spectra_on_device
    from is3d2_tpu_torch.tools.synthetic import make_ensemble
    surfs = make_ensemble(ENSEMBLE_SURFACES, ENSEMBLE_CELLS, ENSEMBLE_SEED0,
                          **ENSEMBLE_SURFACE)
    species, chosen, grids, laguerre, df_data = ensemble_inputs(
        wd1, 1, surfs[0])
    cfg = Config.from_file(wd1 / "iS3D_parameters.dat")
    cfg = dataclasses.replace(cfg, df_mode=1, compute_dtype="f32c",
                              cell_block=ENSEMBLE_CELLS)
    args = (species, chosen, grids, df_data, cfg)

    # one surface's enqueue at full width synchronizes nothing
    spectra_on_device(surfs[0], *args, "cuda")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spectra_on_device(surfs[0], *args, "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    print("one surface's route queued under sync debug mode 'error': no "
          "synchronizing operation")

    def pipeline():
        return compute_spectra_ensemble(surfs, *args,
                                        surface_chunk=ENSEMBLE_CHUNK)

    def plain_loop():
        return [compute_spectra(s, *args, "cuda") for s in surfs]

    # in turns, pipeline, loop, loop, pipeline, each timed by its wall and
    # by CUDA events around every launch; the launch count of the first
    torch.cuda.reset_peak_memory_stats()
    with timed_launches() as spans:
        out, launches, wall = counted(pipeline, "cooper_frye_comp",
                                      ENSEMBLE_SURFACES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = {"pipeline": [span_stats(spans, wall)], "plain_loop": []}
    for name, fn in (("plain_loop", plain_loop), ("plain_loop", plain_loop),
                     ("pipeline", pipeline)):
        with timed_launches() as spans:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[name].append(span_stats(spans, wall))
        if name == "plain_loop":
            # every surface equals its single run, bit for bit
            for i, one in enumerate(res):
                if not np.array_equal(out[i], one):
                    raise AssertionError(f"ensemble surface {i} differs "
                                         "from its single run")
        elif not np.array_equal(res, out):
            raise AssertionError("two ensemble runs gave different bits")
        del res
    if out.shape != (ENSEMBLE_SURFACES, len(chosen), 51, 48, 1) \
            or not np.isfinite(out).all() or (out < 0).any():
        raise AssertionError(f"ensemble spectra: shape {out.shape}, or a "
                             "value not finite or negative")
    print(f"spectra {out.shape} f64, {out.nbytes / 1e6:.1f} MB on the host; "
          f"all {ENSEMBLE_SURFACES} surfaces bit-equal to single "
          f"compute_spectra runs; peak device memory {peak_gb:.3f} GB")
    first = compute_spectra_ensemble(surfs[:8], *args)
    if not np.array_equal(first, out[:8]):
        raise AssertionError("surface_chunk None differs on the first 8")
    print("surface_chunk None on the first 8 surfaces: equal bits")
    for name, rs in runs.items():
        for r in rs:
            print(f"{name}: wall {r['wall_s']:.3f} s, {r['launches']} "
                  f"launches, kernel {r['kernel_ms']:.1f} ms (median "
                  f"{r['kernel_ms_each']['median']:.2f} ms a surface), busy "
                  f"{100 * r['busy_share']:.1f} %, gap between launches "
                  f"median {r['gap_ms']['median']:.3f} ms, max "
                  f"{r['gap_ms']['max']:.3f} ms")
    ratio = (np.mean([r["wall_s"] for r in runs["pipeline"]])
             / np.mean([r["wall_s"] for r in runs["plain_loop"]]))
    print(f"pipeline wall / plain loop wall: {ratio:.4f}")
    return {"surfaces": ENSEMBLE_SURFACES, "cells": ENSEMBLE_CELLS,
            "launches": launches["cooper_frye_comp"], **runs,
            "pipeline_over_plain_loop_wall": float(ratio),
            "peak_device_memory_gb": peak_gb,
            "evaluations_per_surface": ENSEMBLE_CELLS * 12 * out[0].size}


def phase_ensemble_sampler(wd1: Path) -> dict:
    print(f"== 28. ensemble sampler: phase 27's {ENSEMBLE_SURFACES} "
          f"surfaces, df 1, {ENSEMBLE_EVENTS} events a surface into the test "
          f"histograms, y_cut 3, seed {ENSEMBLE_SAMPLER_SEED}")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.core import ensemble as ens
    from is3d2_tpu_torch.core.sampler import sample_particles, surface_seed
    from is3d2_tpu_torch.core.sampler_hist import ChunkBinner
    from is3d2_tpu_torch.physics.deltaf import compute_particle_densities
    from is3d2_tpu_torch.tools.synthetic import make_ensemble
    surfs = make_ensemble(ENSEMBLE_SURFACES, ENSEMBLE_CELLS, ENSEMBLE_SEED0,
                          **ENSEMBLE_SURFACE)
    species, chosen, _, laguerre, df_data = ensemble_inputs(wd1, 1, surfs[0])
    cfg = dataclasses.replace(Config.from_file(wd1 / "iS3D_parameters.dat"),
                              operation=2, df_mode=1, y_cut=3.0, fast=1,
                              cell_block=ENSEMBLE_CELLS)
    args = (surfs, species, chosen, df_data, cfg, laguerre, ENSEMBLE_EVENTS,
            1 << 19)
    diags = []
    inner = ens.sample_particles

    def kept_and_drawn(*a, **kw):
        d = inner(*a, **kw)
        diags.append(d)
        return d

    ens.sample_particles = kept_and_drawn
    try:
        (hists, overflow), _, wall = counted(
            lambda: ens.sample_ensemble_histograms(
                *args, seed=ENSEMBLE_SAMPLER_SEED,
                surface_chunk=ENSEMBLE_CHUNK), None, 0)
    finally:
        ens.sample_particles = inner
    kept = sum(d["kept"] for d in diags)
    drawn = sum(d["drawn"] for d in diags)
    print(f"{len(diags)} surfaces sampled in {wall:.3f} s: {kept} kept / "
          f"{drawn} drawn hadrons ({drawn / kept:.3f} drawn a kept one); "
          f"overflow {int(overflow.sum())}")
    if overflow.any() or kept < ENSEMBLE_SURFACES * ENSEMBLE_EVENTS:
        raise AssertionError("ensemble sampler: overflow or no hadrons")
    again, _ = ens.sample_ensemble_histograms(*args,
                                              seed=ENSEMBLE_SAMPLER_SEED)
    for k in hists:
        if not np.array_equal(hists[k], again[k]):
            raise AssertionError(f"{k}: surface_chunk None differs")
    print("surface_chunk 16 and None: equal bits on all 64 surfaces")
    for i in (0, ENSEMBLE_SURFACES - 1):
        table = dataclasses.replace(species)
        compute_particle_densities(table, df_data, laguerre,
                                   surfs[i].thermo_averages())
        binner = ChunkBinner(len(chosen), cfg)
        sample_particles(surfs[i], table, chosen, df_data, cfg, laguerre,
                         ENSEMBLE_EVENTS, "cuda",
                         seed=surface_seed(ENSEMBLE_SAMPLER_SEED, i),
                         chunk_consumer=binner)
        one = binner.result(ENSEMBLE_EVENTS)
        for k in hists:
            if not np.array_equal(hists[k][i], getattr(one, k)):
                raise AssertionError(f"surface {i}, {k}: differs from its "
                                     "single run")
    print("surfaces 0 and 63 bit-equal to sample_particles + ChunkBinner "
          "with surface_seed(5, i)")
    return {"surfaces": ENSEMBLE_SURFACES, "events_per_surface":
            ENSEMBLE_EVENTS, "kept": kept, "drawn": drawn,
            "compute_s": wall, "dN_dy_shape": list(hists["dN_dy"].shape)}


def check_single_runs(label, surfs, inputs, cfg, kernel):
    """The ensemble of ``surfs`` (``kernel`` launches once a surface, no
    other) against single compute_spectra runs, bit for bit."""
    from is3d2_tpu_torch.core.ensemble import compute_spectra_ensemble
    from is3d2_tpu_torch.core.spectra import compute_spectra
    species, chosen, grids, laguerre, df_data = inputs
    args = (species, chosen, grids, df_data, cfg)
    with timed_launches() as spans:
        out, launches, wall = counted(
            lambda: compute_spectra_ensemble(surfs, *args, laguerre,
                                             surface_chunk=ENSEMBLE_CHUNK),
            kernel, len(surfs))
    stats = span_stats(spans, wall)
    for i, s in enumerate(surfs):
        if not np.array_equal(out[i], compute_spectra(s, *args, "cuda",
                                                      laguerre)):
            raise AssertionError(f"{label}: surface {i} differs from its "
                                 "single run")
    if not np.isfinite(out).all():
        raise AssertionError(f"{label}: spectra not finite")
    print(f"{label}: {len(surfs)} surfaces, {launches[kernel]} launches of "
          f"{kernel}, wall {wall:.3f} s, kernel {stats['kernel_ms']:.1f} ms, "
          f"busy {100 * stats['busy_share']:.1f} %; every surface bit-equal "
          "to its single run")
    return stats


def phase_ensemble_routes(tmp: Path, wd1: Path, wd3: Path) -> dict:
    print("== 29. ensemble routes: B3 (df 4, df 5), B2, B1's and B3's 3+1d "
          "modes, each surface against its single run; OSCAR particle "
          "lists")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.core.ensemble import sample_ensemble_particle_lists
    from is3d2_tpu_torch.tools.synthetic import (make_ensemble,
                                                 make_eos_consistent,
                                                 make_surface)
    base = dataclasses.replace(Config.from_file(wd1 / "iS3D_parameters.dat"),
                               cell_block=ENSEMBLE_CELLS)
    r = {}
    surfs = make_ensemble(8, ENSEMBLE_CELLS, ENSEMBLE_SEED0, shear_scale=0.2,
                          bulk_scale=0.1)
    r["df4"] = check_single_runs(
        "df 4, f32, shear 0.2, bulk 0.1", surfs,
        ensemble_inputs(wd1, 4, surfs[0]),
        dataclasses.replace(base, df_mode=4, compute_dtype="f32"),
        "cooper_frye_feqmod")
    surfs = make_ensemble(4, ENSEMBLE_CELLS, ENSEMBLE_SEED0,
                          **ENSEMBLE_SURFACE)
    inputs = ensemble_inputs(wd1, 5, surfs[0])
    surfs = [make_eos_consistent(s, inputs[0], inputs[3], "cuda")
             for s in surfs]
    r["df5"] = check_single_runs(
        "df 5, f32, EOS-consistent", surfs, inputs,
        dataclasses.replace(base, df_mode=5, compute_dtype="f32"),
        "cooper_frye_feqmod")
    surfs = make_ensemble(4, ENSEMBLE_CELLS, ENSEMBLE_SEED0,
                          **ENSEMBLE_SURFACE)
    r["df2_use_pallas"] = check_single_runs(
        "df 2, f64, use_pallas 1", surfs, ensemble_inputs(wd1, 2, surfs[0]),
        dataclasses.replace(base, df_mode=2, compute_dtype="f64",
                            use_pallas=1), "cooper_frye_f32")
    surfs = [make_surface(ENSEMBLE_CELLS, seed=ENSEMBLE_SEED0 + i,
                          dimension=3) for i in range(4)]
    cfg3 = dataclasses.replace(Config.from_file(wd3 / "iS3D_parameters.dat"),
                               df_mode=1, compute_dtype="f32c",
                               cell_block=ENSEMBLE_CELLS)
    r["3d"] = check_single_runs("3+1d df 1, f32c, 21 y", surfs,
                                ensemble_inputs(wd3, 1, surfs[0]), cfg3,
                                "cooper_frye_comp_3d")
    surfs = [make_surface(ENSEMBLE_CELLS, seed=ENSEMBLE_SEED0 + i,
                          dimension=3, shear_scale=0.2, bulk_scale=0.1)
             for i in range(4)]
    r["3d_df4"] = check_single_runs(
        "3+1d df 4, f32, shear 0.2, bulk 0.1", surfs,
        ensemble_inputs(wd3, 4, surfs[0]),
        dataclasses.replace(cfg3, df_mode=4, compute_dtype="f32"),
        "cooper_frye_feqmod_3d")
    surfs = [make_surface(ENSEMBLE_CELLS, seed=ENSEMBLE_SEED0 + i,
                          dimension=3, **ENSEMBLE_SURFACE) for i in range(4)]
    inputs = ensemble_inputs(wd3, 5, surfs[0])
    surfs = [make_eos_consistent(s, inputs[0], inputs[3], "cuda")
             for s in surfs]
    r["3d_df5"] = check_single_runs(
        "3+1d df 5, f32, EOS-consistent", surfs, inputs,
        dataclasses.replace(cfg3, df_mode=5, compute_dtype="f32"),
        "cooper_frye_feqmod_3d")

    surfs = make_ensemble(8, ENSEMBLE_CELLS, ENSEMBLE_SEED0,
                          **ENSEMBLE_SURFACE)
    species, chosen, _, laguerre, df_data = ensemble_inputs(wd1, 1, surfs[0])
    cfg = dataclasses.replace(base, operation=2, df_mode=1, y_cut=3.0,
                              fast=1)
    root = tmp / "ensemble_lists"
    stats, _, wall = counted(lambda: sample_ensemble_particle_lists(
        surfs, species, chosen, df_data, cfg, laguerre, ENSEMBLE_EVENTS,
        1 << 19, root, seed=ENSEMBLE_SAMPLER_SEED,
        surface_chunk=ENSEMBLE_CHUNK), None, 0)
    rows_all = 0
    for i, st in enumerate(stats):
        files = sorted((root / f"surface_{i}").glob("particle_list_osc_*"))
        rows = sum(f.read_bytes().partition(b"\n")[2].count(b"\n")
                   for f in files)
        if not (len(files) == ENSEMBLE_EVENTS == st["events_written"]
                and rows == st["kept"] == st["rows_written"] > 0):
            raise AssertionError(f"surface {i}: {len(files)} files, {rows} "
                                 f"rows, stats {st}")
        rows_all += rows
    print(f"OSCAR particle lists: {len(stats)} surfaces x {ENSEMBLE_EVENTS} "
          f"files, {rows_all} rows = kept = rows_written, {wall:.3f} s")
    r["particle_lists"] = {"surfaces": len(stats), "rows": rows_all,
                           "wall_s": wall}
    return r


# ----------------------------------------------------------------------
# phases 30-34: 3+1d df 3/4/5 (B3's 3+1d mode, the f64 engines, op 0, op 2)
# ----------------------------------------------------------------------

def split_route(ops, cfg, state, label: str, timed: bool = False) -> dict:
    """B3's 3+1d route on ``ops`` -- the clean kernel on the leading clean
    cells, the mixed kernel on the touched ones -- against the one kernel
    it replaced, the mixed kernel on every cell (fk.launch_3d): equal bits
    on the clean cells alone at one split (each term has the same bits in
    both kernels), <= SPLIT_TOL on all cells (only the order of the f64
    additions moves).  ``timed``: the route's two kernels on their own
    cells and the mixed kernel on every cell, by CUDA events."""
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    args = (*ops.args(), cfg, ops.kind)
    C, n = ops.cols.shape[0], int(ops.n_clean)

    def cells(lo, hi):
        return (ops.cols[lo:hi].contiguous(), ops.cold[lo:hi].contiguous(),
                ops.mom, ops.y, ops.renorm[lo:hi].contiguous(),
                ops.red[lo:hi].contiguous(), ops.n_per_species, cfg, ops.kind)

    def none():
        pass

    route = fk.cooper_frye_feqmod_3d(*args, **ops.layout())
    g = fk.cooper_frye_feqmod_3d.last_geometry
    g_clean = fk.cooper_frye_feqmod_3d.last_clean_geometry
    mixed_ms, mixed = cuda_ms(lambda: fk.launch_3d(*args, g), none)
    vs_mixed = kc.max_rel_err(kc.spectra_units(state, route),
                              kc.spectra_units(state, mixed))
    clean = cells(0, n)
    one_clean, one = (dataclasses.replace(x, n_split=1, cells_per_split=n)
                      for x in (g_clean, g))
    equal = bool(torch.equal(fk.launch_3d_split(*clean, one_clean, one),
                             fk.launch_3d(*clean, one)))
    r = {"n_clean": n, "touched_cells": C - n,
         "route_vs_mixed_kernel": vs_mixed,
         "clean_cut_equal_bits_at_one_split": equal,
         "clean_geometry": dataclasses.asdict(g_clean),
         "mixed_geometry": dataclasses.asdict(g)}
    if timed:
        touched = cells(n, C)
        r["clean_kernel_ms"] = cuda_ms(
            lambda: fk.launch_3d_split(*clean, g_clean, g), none)[0]
        r["touched_kernel_ms"] = cuda_ms(
            lambda: fk.launch_3d(*touched, g), none)[0]
        r["mixed_kernel_all_cells_ms"] = mixed_ms
    print(f"{label}: {n} clean + {C - n} touched cells; route vs the mixed "
          f"kernel on every cell {vs_mixed:.3e}; clean cells alone at one "
          f"split equal bits {equal}"
          + (f"; clean kernel {r['clean_kernel_ms']:.1f} ms, touched "
             f"{r['touched_kernel_ms']:.1f} ms, the mixed kernel on every "
             f"cell {mixed_ms:.1f} ms" if timed else "")
          + f"; clean {g_clean}, mixed {g}")
    if not (equal and vs_mixed <= SPLIT_TOL):
        raise AssertionError(f"{label}: the split route departs from the "
                             f"mixed kernel ({vs_mixed:.3e}, equal bits on "
                             f"the clean cells {equal})")
    return r


def phase_b3_3d_compare(wd: Path) -> dict:
    print("== 30. B3's 3+1d mode vs plain version vs f64 engines (2048 "
          "cells of a 3+1d surface, 16 species, 51 x 48 x 21 y; shear 0.2, "
          "bulk 0.1; famod on an EOS-consistent surface)")
    from is3d2_tpu_torch.tools import kernel_check as kc
    cases = {name: kc.check_feqmod_3d_case(wd, name, 2048, 7, "cuda",
                                           cell_block=512)
             for name in kc.FEQMOD_3D_CASES}
    cases["df4 narrow window"] = kc.check_feqmod_3d_case(
        wd, "df4", 2048, 7, "cuda", narrow=True, cell_block=512)
    for n_y in kc.RAGGED_Y:
        cases[f"ragged {json.dumps(kc.RAGGED)} x {n_y} y"] = \
            kc.check_feqmod_3d_ragged_case(wd, 2048, 7, "cuda", n_y=n_y)
    out = {}
    for name, r in cases.items():
        print(f"{name:26s} breakdown cells {r.breakdown_cells:4d}  narrow "
              f"pairs {r.narrow_pairs:3d}  kernel vs plain {r.vs_plain:.3e}"
              f"  kernel vs f64 {r.vs_f64:.3e}  plain vs f64 "
              f"{r.plain_vs_f64:.3e}  max |kernel - plain| "
              f"{np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"3+1d {name}: kernel disagrees, does not "
                                 f"repeat or no cell breaks down "
                                 f"({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")
        out[name] = {"vs_plain": r.vs_plain, "vs_f64": r.vs_f64,
                     "breakdown_cells": r.breakdown_cells,
                     "narrow_pairs": r.narrow_pairs}
    if cases["df4 narrow window"].narrow_pairs < 1:
        raise AssertionError("no (cell, y) pair in the narrow window")
    # each case's route against the mixed kernel on every cell
    for name in list(kc.FEQMOD_3D_CASES) + ["df4 narrow window"]:
        case = "df4" if name == "df4 narrow window" else name
        cfg, state, ops = kc.feqmod_3d_operands(
            wd, case, 2048, 7, "cuda", narrow=case != name, cell_block=512)
        out[name]["split"] = split_route(ops, cfg, state, name)
    return out


def parse_breakdown(out: str, kind: str) -> int:
    return int(re.search(rf"^{kind} breaks down for (\d+) /", out,
                         re.M).group(1))


def phase_b3_3d_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 31. 3+1d df-4 main path: {MAIN_CELLS} cells of a 3+1d "
          "surface, all species, 51 x 48 x 21 y, f32, shear 0.2, bulk 0.1")
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    t0 = time.perf_counter()
    wd = write_workdir(tmp / "main_3d_df4", n_cells=MAIN_CELLS, dimension=3,
                       params={"df_mode": 4, "compute_dtype": "f32"},
                       **kc.FEQMOD_SURFACE)
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, out = run_cli(wd, "cooper_frye_feqmod_3d")
    if launches["cooper_frye_feqmod_3d"] != 1:
        raise AssertionError("the 3+1d df-4 path did not launch B3's 3+1d "
                             "mode once")
    n_break = parse_breakdown(out, "feqmod")
    print(f"stage seconds: {json.dumps(stages)}; breakdown cells {n_break}")
    if n_break < 1:
        raise AssertionError("no cell of the 3+1d df-4 path broke down")
    check_3d_spectra_files(wd)
    return launches["cooper_frye_feqmod_3d"], stages, wd


def b3_3d_ops(ops, n: int) -> float:
    """Operations of B3's 3+1d mode on the first n operand cells: the
    linearised branch on the breakdown cells and on the window's (cell, y)
    rows, the modified branch on the rest (BOUND_OPS_PER_EVALUATION)."""
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    per = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod_3d"]
    pre = "famod_" if ops.kind == "famod" else ""
    M = ops.mom.shape[1]
    brk = ops.cols[:n, fk.BREAKS_3] != 0
    n_b = (int(brk.sum()) * M
           + int((ops.window()[:n] & ~brk[:, None]).sum()) * (M // ops.n_y))
    return per[pre + "breakdown"] * n_b + per[pre + "modified"] * (n * M - n_b)


def phase_b3_3d_full(wd: Path, clean_build: dict) -> dict:
    print("== 32. B3's 3+1d mode on the 3+1d df-4 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.feqmod_engine_state)
    ops = fk.feqmod_operands_3d(*state, cfg)
    kernel = functools.partial(fk.cooper_frye_feqmod_3d, **ops.layout())
    plain = functools.partial(fk.cooper_frye_feqmod_3d_plain, **ops.layout())
    args = (*ops.args(), cfg, ops.kind)
    C, M = ops.cols.shape[0], ops.mom.shape[1]
    brk = int((ops.cols[:, fk.BREAKS_3] != 0).sum())
    pairs = kc.narrow_pairs(ops)
    print(f"{C} live cells x {M} momenta (M mod 256 = {M % 256}) = "
          f"{ops.evaluations:.4g} evaluations; {brk} breakdown cells, "
          f"{pairs} (cell, y) pairs in the narrow window")
    r = timed_3d(kernel, args, ops.evaluations)
    g = fk.cooper_frye_feqmod_3d.last_geometry
    g_clean = fk.cooper_frye_feqmod_3d.last_clean_geometry
    print(f"launched with clean {g_clean}, mixed {g}; the clean kernel's "
          f"build {json.dumps(clean_build)}")
    split = split_route(ops, cfg, state, "phase 32", timed=True)

    def cut(n):     # the first n live cells, clean and touched
        return (*ops.first(n).args(), cfg, ops.kind)

    n = B3_3D_COMPARE_CELLS
    n_brk = int((ops.first(n).cols[:, fk.BREAKS_3] != 0).sum())
    print(f"compared on the first {n} live cells at the full M ({n_brk} "
          "breakdown cells among them)")
    if n_brk < 1:
        raise AssertionError("no breakdown cell among the compared cells")
    ms, plain_ms, max_abs = compare_on_cut(
        kernel, plain, cut(64), cut(n),
        lambda flat: kc.spectra_units(state, flat), kc.FEQMOD_TOL_PLAIN,
        "B3 3+1d")
    main_bound = bound(b3_3d_ops(ops, C), args, M)["bound_ms"]
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / r['main_path_ms']:.1f} % of it")
    return {"register_tile": g_clean.r, "register_tile_y": g_clean.ty,
            "threads": g_clean.threads, "cell_split": g_clean.n_split,
            "split": split, "clean_kernel_build": clean_build,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(b3_3d_ops(ops.first(n), n), cut(n), M),
            "main_path_bound_ms": main_bound,
            "main_path_share_of_bound": main_bound / r["main_path_ms"],
            **r, "breakdown_cells": brk, "narrow_pairs": pairs,
            # no single PyTorch call computes a Cooper-Frye sum
            "library_ms": None, "cells_compared": n}


def phase_famod_3d(tmp: Path) -> tuple[int, dict, Path, dict]:
    print(f"== 33. 3+1d df-5 main path: {MAIN_CELLS} cells of an "
          "EOS-consistent 3+1d surface, all species, 51 x 48 x 21 y, f32")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    t0 = time.perf_counter()
    wd = write_workdir(tmp / "main_3d_df5", n_cells=MAIN_CELLS, dimension=3,
                       eos_consistent=True, device="cuda",
                       params={"df_mode": 5, "compute_dtype": "f32"},
                       **kc.FAMOD_SURFACE)
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, out = run_cli(wd, "cooper_frye_feqmod_3d")
    if launches["cooper_frye_feqmod_3d"] != 1:
        raise AssertionError("the 3+1d df-5 path did not launch B3's 3+1d "
                             "famod mode once")
    n_break = parse_breakdown(out, "famod")
    print(f"stage seconds: {json.dumps(stages)}; breakdown cells {n_break}")
    check_3d_spectra_files(wd)
    cfg, state = main_path_state(wd, kc.famod_engine_state)
    ops = fk.famod_operands_3d(*state, cfg)
    args = (*ops.args(), cfg, ops.kind)
    r = timed_3d(functools.partial(fk.cooper_frye_feqmod_3d, **ops.layout()),
                 args, ops.evaluations)
    r["split"] = split_route(ops, cfg, state, "phase 33", timed=True)
    main_bound = bound(b3_3d_ops(ops, ops.cols.shape[0]), args,
                       ops.mom.shape[1])
    print(f"bound at full size {main_bound['bound_ms']:.1f} ms: "
          f"{100 * main_bound['bound_ms'] / r['main_path_ms']:.1f} % of it")
    return launches["cooper_frye_feqmod_3d"], stages, wd, {
        **r, "main_path_bound_ms": main_bound["bound_ms"],
        "main_path_share_of_bound": main_bound["bound_ms"]
        / r["main_path_ms"], "breakdown_cells": n_break,
        "narrow_pairs": kc.narrow_pairs(ops), "stage_seconds": stages}


def phase_3d_df345_operations(tmp: Path, wd4: Path, wd5: Path) -> dict:
    print(f"== 34. 3+1d operation 0 (df 4, phase 31's surface cut to its "
          f"first {OP0_3D_DF4_CELLS} cells, the f64 engine) and operation 2 "
          "(df 4 and df 5 into histograms)")
    from is3d2_tpu_torch.core.spectra import compute_spectra
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.tools import kernel_check as kc
    wd = derived_workdir(tmp, wd4, "op0_3d_df4",
                         {"operation": 0, "cell_block": OP0_3D_DF4_CELLS})
    surface = wd / "input/surface.dat"
    with open(surface) as fh:
        head = [next(fh) for _ in range(OP0_3D_DF4_CELLS)]
    surface.write_text("".join(head))
    launches, stages, _ = run_cli(wd, None)
    print(f"stage seconds: {json.dumps(stages)}; {OP0_3D_DF4_CELLS} cells: "
          f"{stages['compute'] / OP0_3D_DF4_CELLS * 1e3:.2f} ms of compute a "
          "cell")
    check_dX_files(wd, None)
    # the same cells through B3's 3+1d mode (operation 1, f32), summed over
    # the y table as operation 0 sums it
    run = IS3D(wd, device="cuda")
    run.load_surface_from_file()
    run._setup()
    cfg = dataclasses.replace(run.cfg, operation=1)
    spectra = compute_spectra(run.surface, run.species, run.chosen_idx,
                              run.grids, run.df_data, cfg, "cuda",
                              run.laguerre)
    g = run.grids
    op1 = np.einsum("p,f,spfy->s", g.pT_weight, g.phi_weight, spectra)
    mcids = [int(run.species.mc_id[i]) for i in run.chosen_idx]
    tau_w = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    errs = {}
    for m in (211, 321, 2212):
        v = np.loadtxt(wd / f"results/continuous/dN_taudtaudy_{m}.dat")
        total = float((v[:, 0] * v[:, 1]).sum() * tau_w)
        ref = float(op1[mcids.index(m)])
        errs[str(m)] = (total - ref) / ref
        print(f"{m}: sum over tau bins {total:.8g} vs B3's 3+1d mode "
              f"summed over y {ref:.8g} ({errs[str(m)]:+.2e})")
    if max(abs(e) for e in errs.values()) > kc.FEQMOD_TOL_F64:
        raise AssertionError("3+1d df-4 operation 0 does not sum to B3's "
                             "dN/dy")
    r = {"operation0": {"cells": OP0_3D_DF4_CELLS, "stage_seconds": stages,
                        "compute_ms_per_cell":
                            stages["compute"] / OP0_3D_DF4_CELLS * 1e3,
                        "vs_b3_3d": errs}}
    for label, src in (("df4", wd4), ("df5", wd5)):
        print(f"-- operation 2, {label}: test histograms, min_num_hadrons "
              "1e6")
        wd = derived_workdir(tmp, src, f"op2_3d_{label}", {
            "operation": 2, "test_sampler": 1, "fast": 1,
            "min_num_hadrons": 1.0e6, "max_num_samples": 1000,
            "sampler_seed": SAMPLER_SEED})
        op2 = run_op2(wd)
        op2["closure"] = closure_3d(wd, src, op2["n_events"])
        r[f"operation2_{label}"] = op2
    return r


def phase_p1_3d_compare(wd: Path) -> dict:
    print("== 35. P1's 3+1d mode vs plain version vs f64 polarization engine "
          "(2048 cells of a 3+1d surface with thermal vorticity, 16 species, "
          "51 x 48 x 21 y)")
    from is3d2_tpu_torch.tools import kernel_check as kc
    cases = {
        "surface": kc.check_polarization_3d_case(wd, 2048, 7, "cuda",
                                                 cell_block=512),
        "near a y node": kc.check_polarization_3d_case(
            wd, 2048, 7, "cuda", near=True, cell_block=512),
        "fast cold cells": kc.check_polarization_3d_case(
            wd, 2048, 7, "cuda", fast_flow=True, cell_block=512)}
    for n_y in kc.RAGGED_Y:
        cases[f"ragged {json.dumps(kc.RAGGED)} x {n_y} y"] = \
            kc.check_polarization_3d_ragged_case(wd, 2048, 7, "cuda",
                                                 n_y=n_y)
    record = {}
    for name, r in cases.items():
        print(f"{name:26s} ({r.launches} launch) kernel vs plain: Snorm "
              f"{r.vs_plain[0]:.3e}, P {r.vs_plain[1]:.3e}; kernel vs f64: "
              f"Snorm {r.vs_f64[0]:.3e}, P {r.vs_f64[1]:.3e}; plain vs f64: "
              f"Snorm {r.plain_vs_f64[0]:.3e}, P {r.plain_vs_f64[1]:.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(
                f"P1 3+1d {name}: kernel disagrees, does not repeat or "
                f"launched {r.launches} times ({r.vs_plain} vs plain, "
                f"{r.vs_f64} vs f64; bars {kc.POLZN_TOL_PLAIN:g} plain, "
                f"{r.f64_bars[0]:g} / {r.f64_bars[1]:g} f64)")
        record[name] = {"vs_plain": r.vs_plain, "vs_f64": r.vs_f64,
                        "plain_vs_f64": r.plain_vs_f64,
                        "f64_bars": r.f64_bars}
    return record


def phase_p1_3d_main_path(tmp: Path) -> tuple[dict, dict, Path]:
    print(f"== 36. 3+1d mode-5 main path: {MAIN_CELLS} cells of a 3+1d "
          "surface with thermal vorticity, all species, 51 x 48 x 21 y, df 1,"
          " f32c: the spectra on B1's 3+1d mode, the polarization on P1's "
          "3+1d mode")
    from is3d2_tpu_torch.io.fastio import load_table_fast
    from is3d2_tpu_torch.io.output import POLARIZATION_FILES
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    t0 = time.perf_counter()
    wd = write_workdir(tmp / "main_3d_mode5", n_cells=MAIN_CELLS,
                       dimension=3, surface_mode=5,
                       params={"df_mode": 1, "compute_dtype": "f32c"})
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, _ = run_cli(wd, "cooper_frye_comp_3d",
                                  also=("polarization_f32_3d",))
    last = pz.polarization_f32_3d.last_launch
    n_species = len(np.loadtxt(wd / "PDG/chosen_particles.dat"))
    rows = n_species * 51 * 48 * 21
    print(f"P1 3+1d's launch: {json.dumps(last)}")
    if not (launches["polarization_f32_3d"] == 1
            and launches["cooper_frye_comp_3d"] == 1
            and last == {"cells": MAIN_CELLS, "momenta": rows, "n_y": 21,
                         "dimension": 3}):
        raise AssertionError("the 3+1d mode-5 main path did not launch B1's "
                             "and P1's 3+1d modes once each, P1 on "
                             f"{MAIN_CELLS} cells and {rows} momenta")
    check_3d_spectra_files(wd)
    t0 = time.perf_counter()
    for name in POLARIZATION_FILES:
        v = load_table_fast(wd / f"results/{name}.dat")
        if v.shape != (rows, 4) or not np.isfinite(v).all():
            raise AssertionError(f"{name}.dat: shape {v.shape} (want "
                                 f"({rows}, 4)) or a value not finite")
        print(f"{name}.dat: {v.shape[0]} rows, finite, max |P| "
              f"{np.abs(v[:, 3]).max():.4e}")
        del v
    print(f"(parsed in {time.perf_counter() - t0:.1f} s); stage seconds: "
          f"{json.dumps(stages)}")
    return launches, stages, wd


def phase_p1_3d_full(wd: Path, sass: dict) -> dict:
    print("== 36. (cont.) P1's 3+1d mode on the main path's operands")
    from is3d2_tpu_torch.io.surface import read_surface
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.polarization_engine_state)
    ops = kc.polarization_operands_3d(state)
    del state
    kernel = functools.partial(pz.polarization_f32_3d, **ops.layout())
    C, M = ops.cell.shape[0], ops.mom.shape[1]
    print(f"{C} real cells x {M} momenta (M mod 256 = {M % 256}) = "
          f"{ops.evaluations:.4g} evaluations")

    def finite(out):
        if not torch.isfinite(out).all():
            raise AssertionError("P1 3+1d at full size: a sum not finite")
        print(f"every sum finite on all {M} momenta; Snorm > 0 on "
              f"{int((out[4] > 0).sum())}")
    r = timed_3d(kernel, ops.args(), ops.evaluations, finite)
    full_ms, clock_max = r["main_path_ms"], r["clocks_sm_mhz"]["max"]
    g = pz.polarization_f32_3d.last_geometry
    print(f"launched with {g}")
    per_eval = BOUND_OPS_PER_EVALUATION["polarization_f32_3d"]

    n = P1_3D_COMPARE_CELLS
    cut = ops.first(n)
    print(f"compared on the first {n} real cells at the full M")
    ms, out = cuda_ms(lambda: kernel(*cut.args()))
    plain_ms, ref = cuda_ms(
        lambda: pz.polarization_f32_3d_plain(*cut.args(), **ops.layout()),
        warmup=lambda: pz.polarization_f32_3d_plain(
            *ops.first(64).args(), **ops.layout()))
    print(f"cut: kernel {ms:.1f} ms, plain version {plain_ms:.1f} ms "
          f"({plain_ms / ms:.1f}x the kernel)")
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    norm_err, p_err = kc.polarization_errors(out, ref)
    max_abs = kc.polarization_units(out, ref)
    print(f"kernel vs plain: Snorm {norm_err:.3e} relative, P {p_err:.3e} of "
          f"max |P| (bar {kc.POLZN_TOL_PLAIN:g}), max |P_kernel - P_plain| "
          f"{max_abs:.3e}")
    if not (np.isfinite(out).all()
            and max(norm_err, p_err) <= kc.POLZN_TOL_PLAIN):
        raise AssertionError("P1 3+1d disagrees with its plain version on "
                             "the main path's operands")
    del out, ref
    main_bound = bound(per_eval * ops.evaluations, ops.args(),
                       5 * M)["bound_ms"]
    sfu = (sass["mufu"] + sass["convert"]) * ops.evaluations
    sfu_floor = sfu / (SFU_LANES_PER_SM * H100_SMS * clock_max * 1e6) * 1e3
    floor = fp32_issue_floor_ms(sass["fp32"], ops.evaluations, clock_max)
    # every instruction takes an issue slot of one of an SM's four
    # schedulers, each a warp of 32 lanes a clock: 128 lanes, as FP32's
    issue = fp32_issue_floor_ms(sass["instructions"], ops.evaluations,
                                clock_max)
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / full_ms:.1f} % of it; sfu_floor_ms "
          f"{sfu_floor:.1f} ({sass['mufu']:.2f} MUFU + {sass['convert']:.2f} "
          f"conversions an evaluation over {SFU_LANES_PER_SM} x {H100_SMS} "
          f"lanes at {clock_max} MHz): {100 * sfu_floor / full_ms:.1f} % of "
          f"it; fp32_issue_floor_ms {floor:.1f} ({sass['fp32']:.2f} FP32 "
          f"instructions an evaluation): {100 * floor / full_ms:.1f} % of "
          f"it; issue_floor_ms {issue:.1f} ({sass['instructions']:.2f} "
          f"instructions an evaluation): {100 * issue / full_ms:.1f} % of "
          f"it")
    record = {"register_tile": g.r, "register_tile_y": g.ty,
              "threads": g.threads, "cell_split": g.n_split,
              "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
              **bound(per_eval * n * M, cut.args(), 5 * M),
              "main_path_bound_ms": main_bound,
              "main_path_share_of_bound": main_bound / full_ms,
              "sfu_floor_ms": sfu_floor,
              "main_path_share_of_sfu_floor": sfu_floor / full_ms,
              "fp32_per_evaluation": sass["fp32"],
              "fp32_issue_floor_ms": floor,
              "main_path_share_of_fp32_floor": floor / full_ms,
              "instructions_per_evaluation": sass["instructions"],
              "issue_floor_ms": issue,
              "main_path_share_of_issue_floor": issue / full_ms, **r,
              # no single PyTorch call computes a polarization sum
              "library_ms": None, "cells_compared": n,
              "snorm_rel_err": norm_err, "p_err": p_err}
    del ops, cut

    # the f64 engine at full width on the surface's first cells
    n = P1_3D_F64_CELLS
    surf = read_surface(wd / "input/surface.dat", cfg.mode, cfg.dimension,
                        bool(cfg.include_baryon))
    surf = dataclasses.replace(surf, **{
        f.name: getattr(surf, f.name)[:n] for f in dataclasses.fields(surf)
        if getattr(surf, f.name) is not None})
    state = kc.polarization_engine_state(wd, dataclasses.replace(
        cfg, cell_block=n), surf, "cuda")
    small = kc.polarization_operands_3d(state)
    out = kernel(*small.args()).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = kc.f64_polarization_3d(state)
    f64_s = time.perf_counter() - t0
    norm_err, p_err = kc.polarization_errors(out, ref)
    print(f"first {n} cells: the f64 engine {f64_s:.1f} s "
          f"({f64_s / n * 1e3:.2f} ms a cell); kernel vs f64: Snorm "
          f"{norm_err:.3e}, P {p_err:.3e} (bars {kc.POLZN_TOL_NORM:g} / "
          f"{kc.POLZN_TOL_P:g})")
    if not (norm_err <= kc.POLZN_TOL_NORM and p_err <= kc.POLZN_TOL_P):
        raise AssertionError("P1 3+1d misses the JAX bars against the f64 "
                             f"engine on the main path's first {n} cells")
    record["vs_f64_first_cells"] = {"cells": n, "snorm_rel_err": norm_err,
                                    "p_err": p_err, "f64_seconds": f64_s}
    return record


# ----------------------------------------------------------------------
# phases 37-39: the tools, the use_pallas = 0 routes, the campaign
# ----------------------------------------------------------------------

# rows x columns of each op-1 file of a 2+1d main path (51 pT x 48 phi);
# dN_pTdpTdphidy has a header line more
OP1_FILE_SHAPES = {"dN_pTdpTdphidy": (51 * 48, 4), "vn": (51, 9),
                   "dN_2pipTdpTdy": (51, 3), "dN_dphidy": (48, 3),
                   "dN_dy": (1, 2)}
# phase 37 reads the values of every 8th species' files in each archive
SWEEP_SAMPLE_STRIDE = 8
# phase 37's grid: each df with shear and bulk delta-f (phase 5's
# corrections); the other three corrections' 12 runs of the default matrix
# (75-93 s of the script's time limit) make room for phases 40-43
SWEEP_CORRECTIONS = ("shear_bulk",)
CAMPAIGN_BATCHES = 4
OBSERVABLE_EVENTS = 20
# compute_observables reads CSV text at ~3e5 hadrons a second on the card's
# host: 20 events of the whole surface (3e6 hadrons) took 9-20 s, 5,000
# cells' ~1.5e5 take well under one
OBSERVABLE_CELLS = 5_000


def check_op1_file(path: Path) -> None:
    """An archived op-1 file of a 2+1d main path: its shape, finite and
    non-negative values.  Read as text, not parsed: rows non-blank lines
    (the blank line after each block is single) of cols tab-separated
    fields, none empty; a value below zero is a field that starts with
    "-"; the writers' "%.8e" and "%.8f" hold no "n", which "nan" and "inf"
    do."""
    kind = path.name.rsplit("_", 1)[0]
    text = path.read_bytes()
    if kind == "dN_pTdpTdphidy":
        text = text.partition(b"\n")[2]
    rows, cols = OP1_FILE_SHAPES[kind]
    if (text.count(b"\n") - text.count(b"\n\n") != rows
            or text.count(b"\t") != rows * (cols - 1)
            or text.startswith((b"\n", b"\t", b"-")) or b"\n\n\n" in text
            or b"\t\t" in text or b"\t\n" in text or b"\n\t" in text
            or b"n" in text or b"\t-" in text or b"\n-" in text):
        raise AssertionError(f"{path}: not {rows} x {cols} values, or one "
                             "not finite or below zero")


def counted_sweep(wd: Path, out: Path, df_names: tuple,
                  corr_names: tuple = ("none", "shear", "bulk", "shear_bulk")
                  ) -> tuple[dict, dict, float, dict]:
    """tools.sweep.run_sweep on ``wd`` with every launch count set to 0
    just before and read just after; returns the archive, each run's
    stage seconds, the wall and every kernel's launches."""
    from is3d2_tpu_torch.tools.sweep import run_sweep
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    timings = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        archive = run_sweep(wd, df_names, corr_names, out_dir=out,
                            device="cuda", timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stages = {f"{df}/{corr}": st for (df, corr), st in timings.items()}
    for run, st in stages.items():
        print(f"{run:18s} {json.dumps(st)}")
    print(f"{len(archive)} runs in {wall:.2f} s; kernel launches {launches}")
    return archive, stages, wall, launches


def phase_sweep(tmp: Path, wd1: Path, wd5: Path) -> dict:
    print(f"== 37. tools.sweep at full width: phase 5's {MAIN_CELLS} cells "
          "(grad, ce, ptm, ptb x shear_bulk; f32c), then famod x none, "
          "shear on phase 14's")
    wd = derived_workdir(tmp, wd1, "sweep", {})
    grid, stages, wall, launches = counted_sweep(
        wd, tmp / "sweep_results", ("grad", "ce", "ptm", "ptb"),
        SWEEP_CORRECTIONS)
    want = {"cooper_frye_comp": 2, "cooper_frye_feqmod": 2}
    if launches != {**dict.fromkeys(launches, 0), **want}:
        raise AssertionError(f"the sweep launched {launches}, not {want}")
    wd_fa = derived_workdir(tmp, wd5, "sweep_famod", {})
    famod, fa_stages, fa_wall, fa_launches = counted_sweep(
        wd_fa, tmp / "sweep_famod_results", ("famod",))
    want = {"cooper_frye_feqmod": 2}
    if fa_launches != {**dict.fromkeys(fa_launches, 0), **want}:
        raise AssertionError(f"the famod sweep launched {fa_launches}, not "
                             f"{want}")
    if sorted(famod) != [("famod", "none"), ("famod", "shear")]:
        raise AssertionError(f"famod ran {sorted(famod)}")
    # every archive holds the file names of its main path (phase 5's,
    # phase 14's); the values of a sample (the files of every
    # SWEEP_SAMPLE_STRIDE-th species and of pi+, K+ and p) are read: all
    # 33,390 files take ~17 s on the card's host, and grad/shear_bulk is
    # held whole to phase 5's bytes below
    ref = wd1 / "results/continuous"
    names = sorted(p.name for p in ref.iterdir())
    t0 = time.perf_counter()
    files, n_files, species = [], 0, set()
    for runs, src in ((grid, wd1), (famod, wd5)):
        want = sorted(p.name for p in (src / "results/continuous").iterdir()
                      if p.name.startswith(("dN", "vn")))
        mcids = sorted({int(n[:-4].rsplit("_", 1)[1]) for n in want})
        sample = {*mcids[::SWEEP_SAMPLE_STRIDE], 211, 321, 2212}
        species |= sample
        for d in runs.values():
            if sorted(p.name for p in d.iterdir()) != want:
                raise AssertionError(f"{d}: not the file names of {src}")
            n_files += len(want)
            files += [d / n for n in want
                      if int(n[:-4].rsplit("_", 1)[1]) in sample]
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(check_op1_file, files))
    print(f"{n_files} archived files, their main paths' names; {len(files)} "
          f"of them ({len(species)} species) of their shapes, finite, >= 0 "
          f"(checked in {time.perf_counter() - t0:.1f} s)")
    # grad with shear and bulk is phase 5's configuration: B1 splits cells
    # without atomics, so its files are phase 5's bytes
    got = grid[("grad", "shear_bulk")]
    if sorted(p.name for p in got.iterdir()) != names or any(
            (got / n).read_bytes() != (ref / n).read_bytes() for n in names):
        raise AssertionError("the sweep's grad/shear_bulk archive differs "
                             "from phase 5's files")
    print(f"grad/shear_bulk: {len(names)} files, phase 5's bytes")
    return {"runs": len(grid) + len(famod), "wall_s": wall + fa_wall,
            "grid_wall_s": wall, "famod_wall_s": fa_wall,
            "launches": {"grid": launches, "famod": fa_launches},
            "stage_seconds": {**stages, **fa_stages}, "files": n_files}


def use_pallas_case(wd: Path, fields: dict, surf, kernel: str) -> dict:
    """One configuration on ``surf`` with the parity workdir's tables,
    through spectra_on_device with use_pallas 0 and -1 (each launches
    ``kernel`` once and nothing else; equal bits) and the f64 engine."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.core.spectra import compute_spectra
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.tools import kernel_check as kc
    cfg = Config(cell_block=512, **fields)
    run = IS3D(wd, cfg=cfg, device="cuda")
    run.surface = surf
    run._setup()
    counters = launch_counters()

    def spectra(**f):
        for fn in counters.values():
            fn.launches = 0
        out = compute_spectra(surf, run.species, run.chosen_idx, run.grids,
                              run.df_data, dataclasses.replace(cfg, **f),
                              "cuda", run.laguerre)
        return out, {k: fn.launches for k, fn in counters.items() if
                     fn.launches}

    off, launched = spectra(use_pallas=0)
    auto, launched_auto = spectra(use_pallas=-1)
    f64, _ = spectra(compute_dtype="f64", use_pallas=-1)
    err = kc.max_rel_err(off, f64)
    r = {"launches": launched, "equal_bits": bool(np.array_equal(off, auto)),
         "vs_f64": err}
    print(f"{json.dumps(fields):62s} {launched}  use_pallas 0 = -1: "
          f"{r['equal_bits']}  vs f64 {err:.3e}")
    if not (launched == launched_auto == {kernel: 1} and r["equal_bits"]
            and np.isfinite(off).all() and err <= kc.FEQMOD_TOL_F64):
        raise AssertionError(f"use_pallas 0 {fields}: {r}")
    return r


def phase_use_pallas0(tmp: Path, wd1: Path, wd_parity: Path) -> dict:
    print("== 38. use_pallas = 0: phase 5's main path, then df 3, df 4 and "
          "df 5 at 2048 cells")
    wd = derived_workdir(tmp, wd1, "main_df1_use_pallas0", {"use_pallas": 0})
    launches, stages, _ = run_cli(wd, "cooper_frye_comp")
    ref, got = wd1 / "results/continuous", wd / "results/continuous"
    names = sorted(p.name for p in ref.iterdir())
    if sorted(p.name for p in got.iterdir()) != names or any(
            (got / n).read_bytes() != (ref / n).read_bytes() for n in names):
        raise AssertionError("the use_pallas = 0 main path's files differ "
                             "from phase 5's")
    print(f"main path, use_pallas 0: {len(names)} files, phase 5's bytes; "
          f"stage seconds {json.dumps(stages)}")
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import make_surface
    surf = make_surface(2048, seed=7, **kc.FEQMOD_SURFACE)
    fa_surf = kc.famod_surface(wd_parity, 2048, 7, "cuda")
    cases = {}
    for fields, s in (({"df_mode": 3, "compute_dtype": "f32"}, surf),
                      ({"df_mode": 4, "compute_dtype": "f32"}, surf),
                      ({"df_mode": 4, "compute_dtype": "f32c"}, surf),
                      ({"df_mode": 5, "compute_dtype": "f32"}, fa_surf)):
        name = f"df{fields['df_mode']} {fields['compute_dtype']}"
        cases[name] = use_pallas_case(wd_parity, fields, s,
                                      "cooper_frye_feqmod")
    return {"main_path": {"launches": launches["cooper_frye_comp"],
                          "stage_seconds": stages}, "cases": cases}


def read_oscar(batch_dir: Path) -> np.ndarray:
    """pid, pz, E of every row of a batch's OSCAR files (n pid px py pz E m
    x y z t after one header line)."""
    return np.concatenate([
        np.loadtxt(f, skiprows=1, usecols=(1, 4, 5), ndmin=2).reshape(-1, 3)
        for f in batch_dir.glob("particle_list_osc_*.dat")])


def phase_campaign(tmp: Path, wd1: Path, op2_hist: dict) -> dict:
    print(f"== 39. tools.oversample on phase 12's workdir: "
          f"{CAMPAIGN_BATCHES} batches of ~2.5e6 hadrons; tools.analysis")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.tools import analysis, oversample
    wd = tmp / "op2_hist"
    events = -(-op2_hist["n_events"] // CAMPAIGN_BATCHES)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        Ntot, batches = oversample.run_campaign(wd, CAMPAIGN_BATCHES, events,
                                                device="cuda")
    wall = time.perf_counter() - t0
    if any(fn.launches for fn in counters.values()):
        raise AssertionError("the campaign launched a Cooper-Frye kernel")
    bar = 0.05 * Ntot + 5.0 * np.sqrt(Ntot / events)
    for b in batches:
        b["dir"] = str(b["dir"])
        per_event = b["kept"] / b["events"]
        print(f"batch {b['batch']} (seed {b['seed']}): kept {b['kept']}, "
              f"{b['events']} events, sampled in {b['sample_seconds']:.3f} s,"
              f" written in {b['write_seconds']:.3f} s; {per_event:.2f} per "
              f"event vs the estimate {Ntot:.2f} (bar {bar:.2f})")
        if abs(per_event - Ntot) >= bar:
            raise AssertionError(f"batch {b['batch']}: kept yield outside "
                                 "the estimate's bound")
    first = {(Path(b["dir"]) / "particle_list_osc_1.dat").read_bytes()
             for b in batches}
    if len(first) != CAMPAIGN_BATCHES:
        raise AssertionError("two batches wrote the same first event")
    print(f"campaign wall {wall:.2f} s; the batches' first events differ")
    # batch 0's dN/dy at |y| < y_cut against phase 5's op-1 files
    t0 = time.perf_counter()
    rows = read_oscar(Path(batches[0]["dir"]))
    y_cut = Config.from_file(wd / "iS3D_parameters.dat").y_cut
    y = 0.5 * np.log((rows[:, 2] + rows[:, 1]) / (rows[:, 2] - rows[:, 1]))
    norm = 2.0 * y_cut * events
    print(f"batch 0: {len(rows)} OSCAR rows parsed in "
          f"{time.perf_counter() - t0:.1f} s")
    if len(rows) != batches[0]["kept"]:
        raise AssertionError("batch 0's OSCAR rows are not its kept count")
    closure = {}
    for m in (211, 321, 2212):
        n = int(((rows[:, 0] == m) & (np.abs(y) < y_cut)).sum())
        smooth = float(np.loadtxt(wd1 / f"results/continuous/dN_dy_{m}.dat")[1])
        sampled, sigma = n / norm, np.sqrt(max(n, 1)) / norm
        closure[str(m)] = {"sampled": sampled, "smooth": smooth,
                           "sigma": sigma}
        print(f"dN/dy {m}: batch 0 {sampled:.6g} (sigma {sigma:.3g}) vs op-1 "
              f"{smooth:.6g}: {(sampled - smooth) / smooth:+.3e} relative")
        if abs(sampled - smooth) >= 5.0 * sigma + 0.01 * smooth:
            raise AssertionError(f"batch 0's dN/dy closure of {m} fails")
    # phase 12's histograms against phase 5's smooth spectra
    shutil.copytree(wd1 / "results/continuous", wd / "results/continuous")
    with contextlib.redirect_stdout(io.StringIO()):
        compare = analysis.compare_sampling_smooth(wd, (211, 321, 2212))
    for m, r in compare.items():
        print(f"compare_sampling_smooth {m}: yield ratio "
              f"{r['yield_ratio']:.5f}, mean per-bin |sampled/smooth - 1| "
              f"{r['mean_dev']:.4f}")
        if not abs(r["yield_ratio"] - 1.0) < 0.05:
            raise AssertionError(f"compare_sampling_smooth {m}: {r}")
    return {"Ntot": Ntot, "events_per_batch": events, "wall_s": wall,
            "batches": batches, "closure": closure,
            "compare_sampling_smooth": {str(m): r for m, r in compare.items()},
            "observables": phase_observables(tmp, wd)}


def phase_observables(tmp: Path, wd_op2: Path) -> dict:
    """tools.analysis.compute_observables on a 20-event op-2 run with CSV
    files, on the op-2 surface cut to its first OBSERVABLE_CELLS cells:
    per event, its identified dN/dy equal to counts from the run's own
    ParticleList (|mcid|, |y| < 0.5)."""
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.tools import analysis
    wd = derived_workdir(tmp, wd_op2, "op2_csv", {
        "test_sampler": 0, "write_csv": 1,
        "max_num_samples": OBSERVABLE_EVENTS})
    surface = wd / "input/surface.dat"
    with open(surface) as fh:
        head = [next(fh) for _ in range(OBSERVABLE_CELLS)]
    surface.write_text("".join(head))
    run = IS3D(wd, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        run.run_particlization()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        obs = analysis.compute_observables(wd)
    seconds = time.perf_counter() - t0
    p = run.final_particles
    E, pz = p.E.astype(np.float64), p.pz.astype(np.float64)
    y = 0.5 * np.log((E + pz) / (E - pz))
    if obs["dN_dy_pion"].shape != (OBSERVABLE_EVENTS,):
        raise AssertionError(f"{obs['dN_dy_pion'].shape[0]} events")
    counts = {}
    for name, m in (("pion", 211), ("kaon", 321), ("proton", 2212)):
        sel = (np.abs(p.mcid) == m) & (np.abs(y) < 0.5)
        direct = np.bincount(p.event[sel], minlength=OBSERVABLE_EVENTS)
        if not np.array_equal(obs[f"dN_dy_{name}"], direct):
            raise AssertionError(f"compute_observables' dN_dy_{name} is not "
                                 "the run's own count")
        counts[name] = float(direct.mean())
    print(f"compute_observables on {OBSERVABLE_EVENTS} events "
          f"({len(p.E)} hadrons) in {seconds:.1f} s: mean dN/dy at |y| < 0.5 "
          f"{json.dumps(counts)}, equal to the run's own counts event by "
          "event")
    return {"events": OBSERVABLE_EVENTS, "hadrons": int(len(p.E)),
            "seconds": seconds, "mean_dN_dy": counts}


# ----------------------------------------------------------------------
# phases 40-43: the multi-device path (parallel/)
# ----------------------------------------------------------------------

# one card stands for four devices: cfg.use_mesh = 1 meshes over
# [cuda:0] * MESH_SLOTS, as (4, 1) and (2, 2)
MESH_SLOTS = 4
MESH_SHAPES = ((4, 1), (2, 2))
# a meshed route against its single-device run: whole cell blocks keep
# each cell's f32 work, so only the order of the f64 additions moves
MESH_TOL = 1e-12
# phase 41's surfaces: phase 3's generator cut to 1,024 cells (the f64
# engines and op 0's per-bin launches set the phase's time), in 4 blocks
# of 256: one a shard of (4, 1), and P1's 3+1d runs of 256 cells whole
MESH_CELLS = 1_024
MESH_BLOCK = 256
# 3+1d op 0 runs the f64 engine (~10 ms a cell at phase 23's width)
MESH_OP0_3D_CELLS = 256
MESH_OP0_3D_BLOCK = 64
# phase 42: phase 12's campaign in chunks of this many drawn hadrons (9
# chunks over the four slots; phase 12 runs 2), and phase 13's
# configuration at 1e6 hadrons in chunks of 1.5e5
MESH_HISTOGRAM_CHUNK = 3.0e6
MESH_OSCAR_HADRONS = 1.0e6
MESH_OSCAR_CHUNK = 1.5e5
MESH_ENSEMBLE_SURFACES = 8


@contextlib.contextmanager
def mesh_devices(devices):
    """parallel/sharding.local_devices replaced by ``devices`` while the
    block runs, so that cfg.use_mesh = 1 meshes over them."""
    from is3d2_tpu_torch.parallel import sharding
    saved = sharding.local_devices
    sharding.local_devices = lambda device=None: list(devices)
    try:
        yield
    finally:
        sharding.local_devices = saved


def mesh_device_lists() -> list:
    """(label, devices) of the meshes phases 40 and 42 run: [cuda:0] x 4,
    and every card where torch sees several."""
    n = torch.cuda.device_count()
    print(f"torch.cuda.device_count() = {n}")
    lists = [("cuda:0 x 4", [torch.device("cuda", 0)] * MESH_SLOTS)]
    if n >= 2:
        lists.append((f"{n} cards",
                      [torch.device("cuda", k) for k in range(n)]))
    return lists


def sync_all() -> None:
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def driver_run(wd: Path, cfg, surf=None, write: bool = False):
    """The driver as a library user calls it (the surface from ``wd`` or
    ``surf`` in memory), with every launch count set to 0 just before and
    read just after.  Returns (run, launches, wall s); run.log is its
    log."""
    from is3d2_tpu_torch.driver import IS3D
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run = IS3D(wd, cfg=cfg, device="cuda")
        if surf is not None:
            run.surface = surf
        run.run_particlization(fo_from_file=surf is None, write=write)
    sync_all()
    wall = time.perf_counter() - t0
    run.log = log.getvalue()
    return run, {name: fn.launches for name, fn in counters.items()}, wall


def expect_launches(launches: dict, want: dict, label: str) -> None:
    full = {**dict.fromkeys(launches, 0), **want}
    if launches != full:
        raise AssertionError(f"{label}: launches {launches}, expected {full}")


def phase_mesh_main_path(wd1: Path) -> dict:
    print(f"== 40. meshed main path: phase 5's workdir ({MAIN_CELLS} cells, "
          "all species, 51 x 48 x 24, df 1, f32c) through the driver's "
          "compute_spectra under meshes (4, 1) and (2, 2) of cuda:0 x 4")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.parallel import sharding
    from is3d2_tpu_torch.tools import kernel_check as kc
    cfg0 = Config.from_file(wd1 / "iS3D_parameters.dat")
    single, launches, wall = driver_run(
        wd1, dataclasses.replace(cfg0, use_mesh=0))
    expect_launches(launches, {"cooper_frye_comp": 1}, "single device")
    ref = single.spectra
    print(f"single device: wall {wall:.2f} s, stage seconds "
          f"{json.dumps(single.stage_seconds)}")
    out = {"single_wall_s": wall,
           "single_stage_seconds": single.stage_seconds, "meshes": {}}
    for label, devices in mesh_device_lists():
        shapes = MESH_SHAPES if label.startswith("cuda:0") \
            else ((len(devices), 1),)
        for shape in shapes:
            cfg = dataclasses.replace(cfg0, use_mesh=1,
                                      mesh_species_shards=shape[1])
            with mesh_devices(devices), timed_launches() as spans:
                run, launches, wall = driver_run(wd1, cfg)
            n = shape[0] * shape[1]
            expect_launches(launches, {"cooper_frye_comp": n},
                            f"{label} {shape}")
            stats = span_stats(spans, run.stage_seconds["compute"])
            err = kc.max_rel_err(run.spectra, ref)
            mesh_line = re.search(r"^mesh: (.*)$", run.log, re.M).group(1)
            shards = [(s["device"], s["cells"], s["species"],
                       (s["geometry"] or {}).get("n_split"))
                      for s in sharding.last_shards]
            print(f"{label} {shape}: mesh {mesh_line}; shards (device, "
                  f"cells, species, cell split) {shards}")
            print(f"  {n} launches of B1, sum of the per-shard CUDA-event "
                  f"ms {stats['kernel_ms']:.1f} (one launch on one device: "
                  f"2,040.3 ms on an H100 80GB HBM3 at 700 W, PERF.md), "
                  f"compute wall "
                  f"{run.stage_seconds['compute']:.3f} s, driver wall "
                  f"{wall:.2f} s, busy {100 * stats['busy_share']:.1f} %; "
                  f"against the single-device spectra {err:.3e} (bar "
                  f"{MESH_TOL:g})")
            if not (np.isfinite(run.spectra).all() and err <= MESH_TOL):
                raise AssertionError(f"meshed main path {label} {shape}: "
                                     f"{err:.3e} off the single device")
            out["meshes"][f"{label} {shape[0]}x{shape[1]}"] = {
                "launches": n, "kernel_ms": stats["kernel_ms"],
                "kernel_ms_each": stats["kernel_ms_each"],
                "compute_s": run.stage_seconds["compute"],
                "wall_s": wall, "busy_share": stats["busy_share"],
                "max_rel_err": err, "shards": shards}
    return out


def _err_spectra(a, b) -> float:
    from is3d2_tpu_torch.tools import kernel_check as kc
    return kc.max_rel_err(np.asarray(a), np.asarray(b))


def _err_dX(a, b, cfg) -> float:
    from is3d2_tpu_torch.tools import kernel_check as kc
    return max(kc.max_rel_err(x, y) for x, y in
               zip(a.normalized(cfg), b.normalized(cfg)))


def _err_polarization(a, b) -> float:
    """Each of the five sums in units of its own max |.| (the spin sums
    cancel between cells)."""
    return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))
               for x, y in zip(a, b))


def phase_mesh_routes(tmp: Path, wd: Path, wd3: Path) -> dict:
    print(f"== 41. meshed routes at {MESH_CELLS} cells (cell_block "
          f"{MESH_BLOCK}), 16 species, 51 x 48 x 24 / 21 y: each under "
          "(4, 1) and (2, 2) of cuda:0 x 4 against its single-device run")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.parallel import sharding
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import make_surface
    mild = make_surface(MESH_CELLS, seed=7)
    feqmod = make_surface(MESH_CELLS, seed=7, **kc.FEQMOD_SURFACE)
    famod = kc.famod_surface(wd, MESH_CELLS, 7, "cuda")
    vort = kc.polarization_surface(MESH_CELLS, 7)
    mild3 = make_surface(MESH_CELLS, seed=7, dimension=3)
    vort3 = make_surface(MESH_CELLS, seed=7, dimension=3, vorticity=True)
    small3 = make_surface(MESH_OP0_3D_CELLS, seed=7, dimension=3)
    feqmod3 = make_surface(MESH_CELLS, seed=7, dimension=3,
                           **kc.FEQMOD_SURFACE)
    spectra = ("spectra", _err_spectra)
    # name -> (workdir, surface, config fields, what is compared, the
    # kernel each shard launches)
    routes = {
        "B3 df 4": (wd, feqmod, {"df_mode": 4, "compute_dtype": "f32"},
                    spectra, "cooper_frye_feqmod"),
        "B3 famod": (wd, famod, {"df_mode": 5, "compute_dtype": "f32"},
                     spectra, "cooper_frye_feqmod"),
        "f64 df 1": (wd, mild, {"df_mode": 1, "compute_dtype": "f64"},
                     spectra, None),
        "f64 df 4": (wd, feqmod, {"df_mode": 4, "compute_dtype": "f64"},
                     spectra, None),
        "B1 3+1d": (wd3, mild3, {"df_mode": 1, "compute_dtype": "f32c"},
                    spectra, "cooper_frye_comp_3d"),
        "op 0 df 1": (wd, mild, {"operation": 0, "df_mode": 1,
                                 "compute_dtype": "f32c"},
                      ("dN_dX", _err_dX), "cooper_frye_comp"),
        "op 0 df 4": (wd, feqmod, {"operation": 0, "df_mode": 4,
                                   "compute_dtype": "f32"},
                      ("dN_dX", _err_dX), "cooper_frye_feqmod"),
        "P1 folded": (wd, vort, {"mode": 5, "df_mode": 1,
                                 "compute_dtype": "f32c"},
                      ("polarization", _err_polarization),
                      "polarization_f32"),
        "P1 3+1d": (wd3, vort3, {"mode": 5, "df_mode": 1,
                                 "compute_dtype": "f32c"},
                    ("polarization", _err_polarization),
                    "polarization_f32_3d"),
        "3+1d op 0 (f64)": (wd3, small3, {"operation": 0, "df_mode": 1,
                                          "compute_dtype": "f32c",
                                          "cell_block": MESH_OP0_3D_BLOCK},
                            ("dN_dX", _err_dX), None),
        # the routes the JAX package keeps on one device under a mesh
        "B2 (one device)": (wd, mild, {"df_mode": 2, "compute_dtype": "f64",
                                       "use_pallas": 1},
                            spectra, "cooper_frye_f32"),
        "B3 3+1d (one device)": (wd3, feqmod3, {"df_mode": 4,
                                                "compute_dtype": "f32"},
                                 spectra, "cooper_frye_feqmod_3d"),
    }
    devices = [torch.device("cuda", 0)] * MESH_SLOTS
    out = {}
    for name, (w, surf, fields, (attr, err_fn), kernel) in routes.items():
        one_device = name.endswith("(one device)")
        base = dataclasses.replace(
            Config.from_file(w / "iS3D_parameters.dat"),
            **{"operation": 1, "cell_block": MESH_BLOCK, "include_baryon": 0,
               "include_baryondiff_deltaf": 0, **fields})
        single, _, single_wall = driver_run(
            w, dataclasses.replace(base, use_mesh=0), surf)
        ref = getattr(single, attr)
        res = {"single_wall_s": single_wall}
        for shape in MESH_SHAPES:
            cfg = dataclasses.replace(base, use_mesh=1,
                                      mesh_species_shards=shape[1])
            sharding.last_shards.clear()
            with mesh_devices(devices):
                run, launches, wall = driver_run(w, cfg, surf)
            got = getattr(run, attr)
            err = (err_fn(got, ref, cfg) if attr == "dN_dX"
                   else err_fn(got, ref))
            n_shards = len(sharding.last_shards)
            print(f"{name:20s} {shape}: {n_shards} shards, launches "
                  f"{ {k: v for k, v in launches.items() if v} }, wall "
                  f"{wall:.2f} s (single {single_wall:.2f} s); against the "
                  f"single-device run {err:.3e}")
            if one_device:
                expect_launches(launches, {kernel: 1}, f"{name} {shape}")
                if n_shards or run.mesh is None or err > MESH_TOL:
                    raise AssertionError(
                        f"{name} {shape}: {n_shards} shards recorded "
                        f"(mesh {run.mesh}), {err:.3e} off the single "
                        f"device (bar {MESH_TOL:g})")
            elif kernel is not None and launches[kernel] < n_shards:
                raise AssertionError(f"{name} {shape}: {kernel} launched "
                                     f"{launches[kernel]} times on "
                                     f"{n_shards} shards")
            elif n_shards < 2 or err > MESH_TOL:
                raise AssertionError(f"{name} {shape}: {n_shards} shards, "
                                     f"{err:.3e} off the single device "
                                     f"(bar {MESH_TOL:g})")
            res[f"{shape[0]}x{shape[1]}"] = {
                "launches": {k: v for k, v in launches.items() if v},
                "shards": n_shards, "wall_s": wall, "max_err": err}
        out[name] = res
    return out


def _histograms_equal(a, b, label: str) -> None:
    """Two runs' test histograms: the counts equal, the v_n sums within
    MESH_TOL of each array's max |.| (CUDA's index_add_ adds f64 with
    atomics, in an order that may move from run to run)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name.startswith("vn_"):
            err = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))
            if err > MESH_TOL:
                raise AssertionError(f"{label}: {f.name} {err:.3e} off")
        elif not np.array_equal(x, y):
            raise AssertionError(f"{label}: {f.name} differs")


def phase_mesh_sampler(tmp: Path) -> dict:
    print("== 42. meshed op 2 through the driver's meshed branches: phase "
          f"12's histogram campaign (chunks of {MESH_HISTOGRAM_CHUNK:g} "
          f"drawn hadrons, compute only) and phase 13's OSCAR files at "
          f"{MESH_OSCAR_HADRONS:g} hadrons (chunks of {MESH_OSCAR_CHUNK:g})")
    from is3d2_tpu_torch.config import Config
    wd_h = tmp / "op2_hist"
    cfg_h = dataclasses.replace(Config.from_file(wd_h / "iS3D_parameters.dat"),
                                sampler_chunk_hadrons=MESH_HISTOGRAM_CHUNK)
    single, launches, wall = driver_run(
        wd_h, dataclasses.replace(cfg_h, use_mesh=0))
    expect_launches(launches, {}, "single-device sampler")
    d = single.sampler_diags
    print(f"single device: {d['kept']} kept, {d['chunks']} chunks, compute "
          f"{single.stage_seconds['compute']:.3f} s, wall {wall:.2f} s")
    out = {"histograms": {"single": {"kept": d["kept"],
                                     "chunks": d["chunks"],
                                     "compute_s":
                                         single.stage_seconds["compute"]}}}
    lists = mesh_device_lists()
    for label, devices in lists:
        with mesh_devices(devices):
            run, launches, wall = driver_run(
                wd_h, dataclasses.replace(cfg_h, use_mesh=1))
        expect_launches(launches, {}, f"{label} sampler")
        _histograms_equal(run.histograms, single.histograms, label)
        m = run.sampler_diags
        if (m["kept"], m["drawn"], m["chunks"]) != (d["kept"], d["drawn"],
                                                    d["chunks"]):
            raise AssertionError(f"{label}: diagnostics differ")
        print(f"{label}: histograms equal the single device's (counts "
              f"exactly, v_n within {MESH_TOL:g}); compute "
              f"{run.stage_seconds['compute']:.3f} s, wall {wall:.2f} s")
        out["histograms"][label] = {"compute_s": run.stage_seconds["compute"],
                                    "wall_s": wall}
    params = {"min_num_hadrons": MESH_OSCAR_HADRONS,
              "sampler_chunk_hadrons": MESH_OSCAR_CHUNK}
    files = {}
    for um, (label, devices) in [(0, lists[0])] + [(1, x) for x in lists]:
        key = "single" if um == 0 else label
        wd = derived_workdir(tmp, tmp / "op2_oscar",
                             f"op2_oscar_mesh_{len(files)}",
                             {**params, "use_mesh": um})
        with mesh_devices(devices):
            run, launches, wall = driver_run(wd, Config.from_file(
                wd / "iS3D_parameters.dat"), write=True)
        expect_launches(launches, {}, f"{key} OSCAR")
        files[key] = sorted((wd / "results").glob("particle_list_osc_*"))
        print(f"{key}: {run.sampler_diags['kept']} kept in "
              f"{run.sampler_diags['chunks']} chunks, {len(files[key])} "
              f"event files, compute {run.stage_seconds['compute']:.3f} s, "
              f"wall {wall:.2f} s")
        out[f"oscar {key}"] = {"kept": run.sampler_diags["kept"],
                               "events": len(files[key]),
                               "compute_s": run.stage_seconds["compute"],
                               "wall_s": wall}
    ref = files.pop("single")
    for key, got in files.items():
        if [p.name for p in got] != [p.name for p in ref] or any(
                a.read_bytes() != b.read_bytes() for a, b in zip(got, ref)):
            raise AssertionError(f"{key}: OSCAR files differ from the "
                                 "single device's")
        print(f"{key}: {len(got)} OSCAR files equal the single device's, "
              "event for event")
    return out


def phase_mesh_ensemble(wd1: Path) -> dict:
    print(f"== 43. meshed ensemble: {MESH_ENSEMBLE_SURFACES} of phase 27's "
          f"surfaces ({ENSEMBLE_CELLS} cells), df 1, f32c, mesh (4, 1) of "
          "cuda:0 x 4")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.core.ensemble import compute_spectra_ensemble
    from is3d2_tpu_torch.core.spectra import compute_spectra
    from is3d2_tpu_torch.parallel.sharding import make_mesh
    from is3d2_tpu_torch.tools.synthetic import make_ensemble
    surfs = make_ensemble(MESH_ENSEMBLE_SURFACES, ENSEMBLE_CELLS,
                          ENSEMBLE_SEED0, **ENSEMBLE_SURFACE)
    species, chosen, grids, laguerre, df_data = ensemble_inputs(
        wd1, 1, surfs[0])
    cfg = dataclasses.replace(Config.from_file(wd1 / "iS3D_parameters.dat"),
                              df_mode=1, compute_dtype="f32c",
                              cell_block=ENSEMBLE_CELLS)
    args = (species, chosen, grids, df_data, cfg)
    mesh = make_mesh(4, 1, [torch.device("cuda", 0)] * MESH_SLOTS)
    with timed_launches() as spans:
        out, launches, wall = counted(
            lambda: compute_spectra_ensemble(surfs, *args, mesh=mesh),
            "cooper_frye_comp", MESH_ENSEMBLE_SURFACES)
    stats = span_stats(spans, wall)
    for i, s in enumerate(surfs):
        if not np.array_equal(out[i], compute_spectra(s, *args, "cuda")):
            raise AssertionError(f"meshed ensemble: surface {i} differs "
                                 "from its single run")
    print(f"{MESH_ENSEMBLE_SURFACES} surfaces in 4 groups, "
          f"{launches['cooper_frye_comp']} launches of B1, wall "
          f"{wall:.3f} s, kernel {stats['kernel_ms']:.1f} ms, busy "
          f"{100 * stats['busy_share']:.1f} %; every surface bit-equal to "
          "its single run")
    return stats


# each phase function's wall seconds (timed), printed before the card's
# line: where the script's time limit goes
PHASE_SECONDS: dict = {}


def timed(fn, *args):
    """fn(*args), its wall seconds added to PHASE_SECONDS under its name."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[fn.__name__] = (PHASE_SECONDS.get(fn.__name__, 0.0)
                                      + time.perf_counter() - t0)


def main() -> int:
    t_start = time.perf_counter()
    card = timed(phase_environment)
    # the package is imported only now: a copy of this script alone, or a
    # machine without a card, fails above or here and prints no result
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import is3d2_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    libraries = timed(phase_build)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    # the SASS counts are parsed in a process of their own (no card, no
    # GIL shared) while phases 3-5 run
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as \
            sass_pool, tempfile.TemporaryDirectory(dir=scratch) as tmp:
        sass_job = sass_pool.submit(sass_counts, libraries)
        tmp = Path(tmp)
        wd, wd_eta = parity_workdirs(tmp)
        timed(phase_b1_compare, wd, wd_eta)
        timed(phase_b3_compare, wd, wd_eta)
        b1_launches, b1_stages, wd1 = timed(phase_b1_main_path, tmp)
        sass = timed(phase_sass, sass_job)
        b1 = timed(phase_b1_full, wd1, b1_stages, sass["b1"])
        b3_launches, _, wd4 = timed(phase_b3_main_path, tmp)
        b3 = timed(phase_b3_full, wd4)
        timed(phase_b2_compare, wd, wd_eta)
        b2_launches, _, wd2 = timed(phase_b2_main_path, tmp)
        b2 = timed(phase_b2_full, wd2)
        op2_hist = timed(phase_sampler_histograms, tmp, wd1)
        op2_oscar = timed(phase_sampler_oscar, tmp, wd4)
        b3f_launches, _, wd5, famod = timed(phase_famod_main_path, tmp)
        b3f = timed(phase_famod_full, wd5)
        op2_famod = timed(phase_famod_sampler, tmp, wd5)
        grouped = timed(phase_grouped_main_path, tmp)
        op0_b1 = timed(phase_op0_b1, tmp, wd1, wd)
        op0_b3 = timed(phase_op0_b3, tmp, wd)
        timed(phase_p1_compare, wd, wd_eta)
        p1_launches, p1_stages, wd_m5 = timed(phase_p1_main_path, tmp)
        p1 = timed(phase_p1_full, wd_m5, sass["p1"])
        timed(phase_b1_3d_compare, parity_workdir_3d(tmp))
        b1_3d_launches, b1_3d_stages, wd3 = timed(phase_b1_3d_main_path,
                                                  tmp)
        b1_3d = timed(phase_b1_3d_full, wd3, sass["b1_3d"])
        op0_3d = timed(phase_op0_3d, tmp, wd3)
        op2_3d = timed(phase_sampler_3d, tmp, wd3)
        ens_spectra = timed(phase_ensemble_spectra, wd1)
        ens_sampler = timed(phase_ensemble_sampler, wd1)
        ens_routes = timed(phase_ensemble_routes, tmp, wd1, wd3)
        b3_3d_parity = timed(phase_b3_3d_compare, parity_workdir_3d(tmp))
        b3_3d_launches, b3_3d_stages, wd3_df4 = timed(
            phase_b3_3d_main_path, tmp)
        b3_3d = timed(phase_b3_3d_full, wd3_df4, sass["b3_3d_clean"])
        b3_3d_famod_launches, _, wd3_df5, b3_3d_famod = timed(
            phase_famod_3d, tmp)
        ops_3d = timed(phase_3d_df345_operations, tmp, wd3_df4, wd3_df5)
        p1_3d_parity = timed(phase_p1_3d_compare, parity_workdir_3d(tmp))
        p1_3d_launches, p1_3d_stages, wd3_m5 = timed(
            phase_p1_3d_main_path, tmp)
        p1_3d = timed(phase_p1_3d_full, wd3_m5, sass["p1_3d"])
        tools = {"sweep": timed(phase_sweep, tmp, wd1, wd5)}
        # phase 37's workdirs and archives (~3.7e4 files) are not read
        # again: removed while phases 38-39 run, not one by one at the end
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            removed = pool.submit(lambda: [shutil.rmtree(tmp / d) for d in (
                "sweep", "sweep_results", "sweep_famod",
                "sweep_famod_results")])
            tools["use_pallas0"] = timed(phase_use_pallas0, tmp, wd1, wd)
            tools["campaign"] = timed(phase_campaign, tmp, wd1, op2_hist)
        removed.result()
        mesh = {"main_path": timed(phase_mesh_main_path, wd1),
                "routes": timed(phase_mesh_routes, tmp, wd,
                                parity_workdir_3d(tmp)),
                "sampler": timed(phase_mesh_sampler, tmp),
                "ensemble": timed(phase_mesh_ensemble, wd1)}
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print("operations per evaluation: counted from the plain versions "
          f"{json.dumps(OPS_PER_EVALUATION)}; executed by the kernels "
          f"{json.dumps(EXECUTED_OPS_PER_EVALUATION)}; the bounds take the "
          f"smaller {json.dumps(BOUND_OPS_PER_EVALUATION)}")
    print(json.dumps({"sampler": {"card": card, "histograms": op2_hist,
                                  "oscar": op2_oscar, "famod": op2_famod,
                                  "histograms_3d": op2_3d}}))
    print(json.dumps({"ensemble": {"card": card, "spectra": ens_spectra,
                                   "sampler": ens_sampler,
                                   "routes": ens_routes}}))
    print(json.dumps({"tools": {"card": card, **tools}}))
    print(json.dumps({"mesh": {"card": card, **mesh}}))
    print(json.dumps({"phase_seconds": PHASE_SECONDS,
                      "total_s": time.perf_counter() - t_start,
                      "card": card}))
    print(card)

    def routes(*names):
        return {n: mesh["routes"][n] for n in names}
    print(json.dumps({"kernels": [
        {"name": "cooper_frye_comp", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_comp.cu",
         "replaces": "is3d2_tpu/ops/cooper_frye_pallas.py:241",
         "launches": b1_launches, **b1,
         # phase 17: the grouped mode-6 main path; phase 18: operation 0,
         # one launch of the per-cell mode (the per-bin route under
         # "per_bin_route")
         "grouped_mode6": grouped, "operation0": op0_b1,
         # phase 27: the 64-surface ensemble, one launch a surface
         "ensemble": {"launches": ens_spectra["launches"],
                      "pipeline": ens_spectra["pipeline"],
                      "plain_loop": ens_spectra["plain_loop"]},
         # phases 40, 41 and 43: the main path under (4, 1) and (2, 2),
         # operation 0, the meshed ensemble
         "mesh": {"main_path": mesh["main_path"],
                  "routes": routes("op 0 df 1"),
                  "ensemble": mesh["ensemble"]}},
        {"name": "cooper_frye_feqmod", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_feqmod.cu",
         "replaces": "is3d2_tpu/ops/cooper_frye_feqmod_pallas.py:68",
         "launches": b3_launches, **b3,
         # the famod mode (df 5) on its own main path, phases 14-15
         "famod": {"launches": b3f_launches, **b3f, **famod},
         # phase 19: operation 0, dan-weighted, one launch per bin
         "operation0": op0_b3,
         # phase 29: ensembles of 8 df-4 and 4 df-5 surfaces
         "ensemble": {"df4": ens_routes["df4"],
                      "famod": ens_routes["df5"]},
         # phase 41: df 4, famod and operation 0 under (4, 1) and (2, 2)
         "mesh": {"routes": routes("B3 df 4", "B3 famod", "op 0 df 4")}},
        {"name": "cooper_frye_f32", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_f32.cu",
         "replaces": "is3d2_tpu/ops/cooper_frye_pallas.py:83",
         "launches": b2_launches, **b2,
         # phase 29: an ensemble of 4 surfaces
         "ensemble": ens_routes["df2_use_pallas"],
         # phase 41: one launch under each mesh, on one device as in JAX
         "mesh": {"routes": routes("B2 (one device)")}},
        {"name": "polarization_f32", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/polarization_f32.cu",
         # an XLA program: the JAX package has no Pallas kernel for it
         "replaces": "is3d2_tpu/core/polarization_fast.py:96",
         "launches": p1_launches["polarization_f32"], **p1,
         # phase 21: the mode-5 main path, B1 for its spectra beside P1
         "mode5_main_path": {"launches": p1_launches,
                             "stage_seconds": p1_stages},
         # phase 41: the cells over "cells"
         "mesh": {"routes": routes("P1 folded")}},
        {"name": "cooper_frye_comp_3d", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_comp.cu",
         # an XLA program (and _block_fast_3d, :353, for f32): the JAX
         # package has no Pallas kernel in 3+1d
         "replaces": "is3d2_tpu/core/spectra_fast.py:461",
         "launches": b1_3d_launches, **b1_3d,
         "stage_seconds": b1_3d_stages,
         # phase 25: operation 0 in 3+1d, the f64 engine on a cut
         "operation0_f64_engine": op0_3d,
         # phase 29: an ensemble of 4 surfaces
         "ensemble": ens_routes["3d"],
         # phase 41: B1's 3+1d mode and 3+1d op 0 (the f64 engine)
         "mesh": {"routes": routes("B1 3+1d", "3+1d op 0 (f64)")}},
        {"name": "cooper_frye_feqmod_3d", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_feqmod.cu",
         # an XLA program: the JAX package has no Pallas kernel in 3+1d
         "replaces": "is3d2_tpu/core/spectra_feqmod_fast.py:480",
         "launches": b3_3d_launches, **b3_3d,
         "stage_seconds": b3_3d_stages,
         # phase 30: parity at 2,048 cells over the modes and flags
         "parity": b3_3d_parity,
         # phase 33: the famod mode on its own main path
         "famod": {"launches": b3_3d_famod_launches, **b3_3d_famod},
         # phase 34: operation 0 on the f64 engine, operation 2
         "operations": ops_3d,
         # phase 29: ensembles of 4 df-4 and 4 df-5 3+1d surfaces
         "ensemble": {"df4": ens_routes["3d_df4"],
                      "famod": ens_routes["3d_df5"]},
         # phase 41: one launch under each mesh, on one device as in JAX
         "mesh": {"routes": routes("B3 3+1d (one device)")}},
        {"name": "polarization_f32_3d", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/polarization_f32.cu",
         # an XLA program: the JAX package has no Pallas kernel for it
         "replaces": "is3d2_tpu/core/polarization_fast.py:138",
         "launches": p1_3d_launches["polarization_f32_3d"], **p1_3d,
         # phase 36: the 3+1d mode-5 main path, B1's 3+1d mode beside it
         "mode5_main_path": {"launches": p1_3d_launches,
                             "stage_seconds": p1_3d_stages},
         # phase 35: parity at 2,048 cells
         "parity": p1_3d_parity,
         # phase 41: the cells over "cells" in MESH_BLOCK = 256-cell
         # blocks, the mode's whole 256-cell f32 runs
         "mesh": {"routes": routes("P1 3+1d")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
