"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the slice configurations
    python3 chip_smoke.py --profile  # plus a profiled Newton step, patch
                                     # solve step, lattice CG solve and
                                     # FSI Newton step

Phases, one JSON line each; any failure exits non-zero.  Slice 1, the
steady Navier-Stokes Newton step on the BELL-frame operator:

1. build   — compile every CUDA kernel of the port from the sources in this
             checkout (one nvcc per source, all started together);
2. kernel  — on the main path's own operator (the cavity Jacobian at the
             initial state, in the sliced-ELL device plan of the solve),
             hold kernel B1 against its plain PyTorch version (f32 and bf16
             values; f64 on random data), time both and one torch.sparse
             CSR matvec of the same matrix with CUDA events, and compute
             the HBM bound of the call (of the bytes it reads: values,
             columns, slice pointers, row order, x, y; and of the nonzeros
             alone), with the layout's fill;
3. main    — the main path: Re=100 lid-driven cavity (Ghia, Ghia & Shin
             1982) on unit_box((16,16)) refined to 4 levels (finest 128x128
             Q2/Q2/P1dc, 181,250 dofs), RCM hierarchy, interleaved dofs,
             operator="bell", Vanka-smoothed V-cycle GMRES in float32, up to
             5 Newton steps through NonLinearImplicitSystem.solve;
   (--profile: one more Newton step under torch.profiler);
4. reference — the same solve at a small size on the card (float32) and on
             the host (float64) must agree.

Slice 2, the patch-stencil operator path (operator="patch", rediscretized
V-cycle, Chebyshev smoothing, GMRES(30) in float32 at rtol 1e-6):

5. patch_setup     — System.init of poisson-patch-1M (-Lap u = 2 pi^2
                     sin(pi x) sin(pi y), homogeneous Dirichlet, on
                     PatchedMultiLevelMesh(unit_box((32,32)), 5): finest
                     512x512 Q2, 1,050,625 dofs, H=33, P=1024) and of
                     elasticity-patch (linear elasticity (DX, DY), lam=1.2,
                     mu=0.8, clamped at x=0, uniform body force, on
                     unit_box((16,16)), 5 levels: 2 x 263,169 dofs);
6. patch_kernel    — on the finest operators after Dirichlet elimination
                     and on random weights of the same shapes, hold the
                     whole matvec of kernel B2 (scalar Poisson; block
                     elasticity) against its plain version, time it, its
                     two launches alone (stencil, combine), the plain
                     version and one torch.sparse CSR matvec of the same
                     Poisson matrix from the port's ELL assembly; count the
                     device kernels of one matvec; HBM bound of the matvec
                     (the weights it reads, x, y, the index tables, see
                     patch_kernel_work) and of the nonzeros alone;
7. patch_main      — LinearImplicitSystem.solve on poisson-patch-1M: wall
                     time, iterations, the true preconditioned residual
                     against the solve's target (bounded by float32, see
                     RESIDUAL_SLACK), nodal error against sin(pi x)
                     sin(pi y) (see PATCH_ERR_MAX), B2 launches, operator
                     routing;
   (--profile: one more solve step under torch.profiler);
8. patch_elasticity — the same solve report for elasticity-patch;
9. patch_reference — both problems on unit_box((4,4)), 3 levels, on the
                     card (float32) and the host (float64) must agree.

Slice 3, the lattice operator path on poisson-lattice-512 (Q2 Poisson on
unit_box((512,512),"quad"), quad_order "fifth", all-Dirichlet, float32:
1,050,625 dofs on a 1025x1025 lattice, 25 diagonals; the same matrix as
poisson-patch-1M) and the solver routes beside the V-cycle:

10. lattice_setup    — generic assembly at u=0 -> ELL -> build_dia_plan ->
                     DiaPlan.apply -> build_stencil (S), and the
                     scatter-free lattice assembly (R, S2); S2 must equal S
                     and R the generic residual to float32 rounding;
                     seconds of each route;
11. lattice_kernel   — hold kernels B4 (DIA) and B3 (2-D stencil) against
                     their plain versions on this operator and on
                     random-data operators (f32 and f64), time both, their
                     plain versions, the generic ELL matvec and one
                     torch.sparse CSR matvec of the same matrix; HBM bound
                     of each call (see lattice_kernel_work) and of the
                     nonzeros alone; B2's and CSR's times of phase 6 beside
                     them;
12. lattice_main     — (a) the normalised power sweep x <- A x / max|A x|
                     from x = 1, 10 + 400 steps, through B3, B4 and the ELL
                     operator: nnz/s of each, the three must agree;
                     (b) -Lap u = 2 pi^2 sin(pi x) sin(pi y) by CG on the
                     stencil operator, preconditioned by a degree-3
                     Chebyshev sweep, rtol 1e-4: iterations, nodal error
                     against sin(pi x) sin(pi y), B3 launches;
   (--profile: one more CG solve under torch.profiler);
13. lattice_reference — set-up, sweep and CG solve at n=16 on the card
                     (float32) and the host (float64) must agree;
14. cycles_reference — the small cavity on the card with mg_cycle W, F and
                     K (K through FGMRES), with operator="matrix_free",
                     with stacked dofs and rediscretized coarse levels
                     (Vanka on each level's own pattern, B1 on the two finer
                     levels), with that hierarchy and the matrix-free one
                     built with compute_dtype=bfloat16 (``cycle_dtype``),
                     and with the V-cycle built in bfloat16
                     (``bf16_newton``: B1 on bfloat16 values, the coarse LU
                     in float32) must converge and agree with the V-cycle
                     solve; a Neumann problem through a face form with
                     operator="matrix_free" must agree with "assembled".

Slice 6, block solvers, norms, boundary-face forms and optimal control on
the BELL-frame operator (kernel B1; see ``oc_system``, constants OC_*):

15. oc_setup      — System.init of oc-distributed-128: elliptic distributed
                    control, y, l, u Q2 on unit_box((16,16)) refined to 4
                    levels (198,147 dofs), stacked dofs, Vanka V-cycle
                    GMRES(60), rtol 1e-6, float32: seconds, dofs, nnz,
                    routing;
16. oc_kernel     — B1 on the fine KKT operator against its plain version
                    (f32, bf16; f64 on random data), cold time, bound, CSR;
17. oc_main       — the unconstrained KKT solve: iterations, seconds, B1
                    launches, J (cost_functional on the card); gates: every
                    linear solve meets rtol, |alpha u - l| <= 1e-6 max(1,
                    |l|), J finite, B1 launched;
   (--profile: one more KKT solve step under torch.profiler);
18. oc_pdas       — 5 PDAS iterations from that optimum, bounds (0.5, 8):
                    active counts and seconds per iteration; gates: linear
                    solves meet rtol, u within the bounds, both active sets
                    non-empty (settling is not gated: ROADMAP C);
19. oc_boundary   — oc-boundary-128 (Neumann control on x = 1,
                    fix_interior_control): iterations, seconds, face
                    assembly device ms; gates: rtol met, the control off
                    the control boundary below OC_OFF_GC_MAX of its size
                    on it, B1 launched;
20. oc_theta      — oc-theta-64, the bordered zero-mean control (operator
                    "assembled", no kernel): theta, Newton steps; gate
                    |B x - g| <= 1e-8 |B| |x|;
21. fieldsplit    — FGMRES(50) on the 148,739-dof cavity Jacobian with the
                    flat Schur split and with the nested Vanka/Jacobi
                    Schur tree: iterations, true residuals, seconds, B1
                    launches; gates: finite, the tree's residual within
                    1.5x the flat one's, B1 launched;
22. convergence   — convergence_study of Q2 Poisson, unit_box((4,4)) over 6
                    levels (finest 128x128), MG-CG rtol 1e-12 in float64,
                    norms on the card; gates: L2 order > 2.7, H1 > 1.8;
23. oc_reference  — card against host in float64 at unit_box((4,4)), 2
                    levels: 3 PDAS iterations, boundary control, theta and
                    one application of each field-split preconditioner (on
                    the 16x16 cavity), to 1e-8 relative.

Slice 5, monolithic ALE fluid-structure interaction on the BELL-frame
operator (kernel B1), with the Petrov-Galerkin R A P hierarchy and
material-split Vanka (``femus_tpu_torch.parallel.cases.fsi_bed``):

24. fsi_setup     — System.init of fsi-bed-64: unit_box((16,16)) refined
                    to 3 levels, finest 64x64, dx, dy, u, v Q2 and p P1dc
                    (78,852 dofs; 4 levels, fsi-bed-128, before slice 9
                    needed the clock), an elastic bed in the bottom quarter;
                    host seconds, dofs, nnz and row lengths per level,
                    R A P schedule sizes;
25. fsi_kernel    — B1 on the FSI fine Jacobian at the initial state, in the
                    solve's own plan: against its plain version with float64
                    values (the solve's) and float32 ones, and on random
                    float64 data; cold time, HBM bound, CSR time in the same
                    types, fill;
26. fsi_main      — NonLinearImplicitSystem.solve in float64 (FSI_DTYPE; F
                    ratchet over the three levels, K-cycle FGMRES, linear
                    rtol 1e-4, up to 8 Newton steps per level, the pressure
                    pinned in the fluid, nu 0.05, lid 0.2): seconds, FGMRES
                    iterations and ||R(u)|| per step, B1 launches, peak
                    device bytes, max |u| in the fluid and max |dx| on the
                    interface; gates:
                    ||R(u)|| on the finest level falls at least 10^3x,
                    every linear solve meets its rtol, B1 launched, finite
                    state;
   (--profile: one more finest-level Newton step, one FGMRES cycle, under
    torch.profiler);
27. fsi_transient — fsi-bed-transient-64 (the same geometry at 3 levels,
                    78,852 dofs, the bed kicked horizontally, dt = 0.01):
                    3 x TransientMonolithicFSI.time_step(); gates: every
                    level's Newton loop converges, the solid's mean u
                    changes between steps, finite state;
28. fsi_reference — steady FSI (lid 0.02) and 2 transient steps on
                    unit_box((4,4)), 2 levels: the card (FSI_DTYPE) against
                    the host (float64), every field to 1e-3 relative.

Slice 7, rediscretized coarse levels for the BELL operator and adaptive
mesh refinement with multigrid across the AMR levels (kernel B1):

29. rediscretize  — right after phase 4: cavity-128 with stacked dofs and
                    coarse_op="rediscretize" (every coarse level assembled
                    on its own mesh at the restricted state each Newton
                    step, Vanka on its own pattern, B1 on every level of
                    at least 2048 rows): GMRES iterations and seconds per
                    step beside cavity-128's; gates: every linear solve
                    meets rtol, ||R(u)|| falls at least 10^3x, B1 launched
                    on every such level (``b1_tally``), u, v and p within
                    1e-3 of cavity-128's Galerkin solution;
30. amr_cycle, amr_kernel, amr — after phase 23: amr-lshape (see
                    ``lshape_mesh``, ``lshape_exact``, constants AMR_*),
                    AMR_CYCLES cycles of solve_mg_amr over the chain (float64,
                    Chebyshev V-cycle CG to 1e-10, B1 on every reduced level
                    but the LU-solved coarsest), Kelly, refine the worst 20 %:
                    per cycle elements, dofs, hanging dofs, iterations,
                    residual, L2 error, host set-up and solve seconds, B1
                    launches by level; B1 on the finest reduced operator
                    against its plain version; solve_conforming on the last
                    cycle of at most 20k dofs; gates: every CG converges
                    (AMR_MAX_ITERS, AMR_ITER_GROWTH), the L2 error falls
                    every cycle, elements two levels deep, multigrid under
                    a third of the diagonal-CG iterations and equal to it
                    to 1e-9;
31. amr_reference — a 3-cycle chain from unit_box((4,4)): solve_mg_amr on
                    the card and on the host in float64 agree to 1e-10 with
                    equal iteration counts.

Slice 8, the remaining assembly forms, surface FE, the batch-first layout,
mixed-element meshes and the nonlocal operator, after phase 31 (kernel B1
on every path; constants BOUS_*, FORMS_*, SURF_N, CONF_N, MIXED_N, SW_*,
NONLOCAL_*):

32. bous_setup, bous_kernel, bous_main — the slice's main path,
                    boussinesq-cavity-128: the de Vahl Davis (1983)
                    differentially heated cavity (Ra = 1e4, Pr = 0.71, hot
                    wall x = 0 at T = 0.5, cold x = 1 at -0.5, insulated top
                    and bottom, no-slip) on unit_box((16,16)) refined to 4
                    levels (u, v, T Q2, p P1dc: 247,299 dofs), configured as
                    cavity-128 (``boussinesq_system``): set-up seconds, B1
                    on the Jacobian at the initial state (f32, bf16; cold
                    time, bound, CSR, fill), then up to BOUS_NEWTON Newton
                    steps; gates: every linear solve meets rtol, ||R(u)||
                    falls 10^3x, T within [-0.5, 0.5] to 1e-3, Nu on the
                    hot wall (``hot_wall_nusselt``), u_max on x = 0.5 and
                    v_max on y = 0.5 times sqrt(Ra Pr) within BOUS_TOL of
                    2.243, 16.178 and 19.617;
33. bous_reference — the cavity on unit_box((4,4)), 3 levels: the card
                    (float32) against the host (float64), every field to
                    1e-3 relative;
34. forms         — forms-128 in float64: the coupled biharmonic
                    (Chebyshev V-cycle GMRES(60) to 1e-10) and Willmore
                    flow of a graph (the sphere cap from its interpolant,
                    Vanka V-cycle, Newton to 1e-11) from unit_box((8,8)) at
                    4 and 5 levels; gates: L2 orders above 2.3 and 2.5, the
                    biharmonic's v/(2 pi^2) within 10x u's error, Newton
                    within 8 steps;
35. surface       — surface-cylinder-256: Laplace-Beltrami on
                    map_to_surface(unit_box((256,256)), half cylinder)
                    (263,169 dofs) and at 128x128, assembled on the card
                    through the manifold geometry, Jacobi-CG on the BELL
                    frame to 1e-10; gates: area pi to 1e-9, L2 order > 2.5;
36. conformal     — conformal-128: conformal_minimization (the batch-first
                    layout) on unit_box((128,128)) from the bumped
                    holomorphic map, Newton with Jacobi-GMRES(60) to 1e-10;
                    gates: <= 12 Newton steps, Dx on 0.1 (x^2 - y^2),
                    0.2 x y to 1e-9, conformal energy < 1e-10;
37. mixed         — mixed-poisson-128: MixedAssembler on
                    mixed_unit_box((128,128)) (quads and triangles) and at
                    64x64, Q2 Poisson, Jacobi-CG on the BELL frame to
                    1e-12; gate: L2 order > 2.5;
38. sw            — sw-128, Crank-Nicolson, dt 0.01, no multigrid: the lake
                    at rest (h, u, v over a bump, 198,147 dofs, 2 steps;
                    gate: still to 1e-8) and a tracer in a uniform drift
                    (66,049 dofs, 40 steps; gate: centre of mass at
                    (0.55 +- 0.04, 0.5 +- 0.02));
39. nonlocal_kernel, nonlocal — nonlocal-64 in float64: the pair assembly
                    on the card (500,970 element pairs, 4,225 rows of up to
                    357 entries), B1 against its plain version on this
                    operator, then solve_dirichlet (CG on the BELL frame);
                    gates: symmetric and A 1 = 0 to rounding, the CG
                    converges, the core shape of tests/test_nonlocal.py.

Slice 9, the mesh readers, Lagrangian markers, explicit MPM and MPM-FSI,
mesh-to-mesh projection and UQ, after phase 39 (constants NEU_*,
MARKERS_*, MAGNETIC_COUNT, MPM_*, MPM_FSI_*, PROJ_*, UQ_*):

40. gambit, gambit_kernel — gambit-poisson-256: unit_box((32,32)) Q2 written
                    as a Gambit .neu file (``write_neu``, four boundary
                    groups), read back with read_neu, refined to 4 levels
                    (finest 256x256, 263,169 dofs), Q2 Poisson (sin sin)
                    with Dirichlet conditions on the read groups, MG-CG on
                    the BELL operator to 1e-12 in float64 on every depth
                    (convergence_study); B1 on the finest operator against
                    its plain version (cold time, bound, CSR); gates: the
                    read mesh equals the written one (coords, conn, groups,
                    boundary faces), every solve meets its rtol, L2 order
                    > 2.7, B1 launched;
41. markers       — markers-256: 2^20 markers in the disk of radius 0.4 on
                    unit_box((256,256)): locate on the card, a quarter of
                    an RK4 revolution through the Q2 rigid rotation in 100
                    steps (400 a revolution);
                    a 4,096-marker subset located and advected (1/20
                    revolution) on the host too; ex05's magnetic capture
                    (a wire at (0.95, 0.5), capped drift, 50 steps) on
                    10^5 markers; gates: every marker located before and
                    after, at the exact rotated start to 1e-6, the
                    subset's owners equal and its
                    positions within 1e-12, the mean distance to the wire
                    falls;
42. mpm           — mpm-block-128: the elastic block of tests/test_mpm.py
                    at 128x128 (``mpm_block``: 23,104 particles, ppc 4,
                    linear transfer, one cell above the fixed floor), 500
                    explicit steps of 2.5e-4 under gravity -1; the 8x8 block
                    50 steps on the card and the host; gates: P2G mass to
                    1e-13, momentum g t to 1e-10 before contact, the floor
                    stops the fall (see phase_mpm), det F in (0.5, 2),
                    card = host to MPM_REF_TOL;
43. mpm_fsi       — mpm-fsi-sinking-64: ex06 at n = 64 (37,507 dofs, 1,482
                    material points), 1 implicit step: assembly with the
                    particle form, P2G and G2P on the card, scipy spsolve
                    on the host (seconds apart); n = 6 for 2 steps on the
                    card and the host; gates: Newton meets newton_tol every
                    step, the centre of mass falls every step, det F in
                    (0.8, 1.2), card = host to 1e-8;
44. projection    — projection-256: projection_matrix from
                    unit_box((256,256)) Q2 onto unit_box((200,200)) Q2
                    shifted by (0.1, -0.05) (160,801 points located on the
                    card); gates: exact on a quadratic to 1e-10 inside, the
                    rows of points outside empty;
45. uq, uq_kernel — uq-pce-128: ex07's collocation (-div(e^xi grad u) = 1
                    at 128x128 Q2, Jacobi-CG to 1e-12 on B1 at each of 7
                    Hermite nodes) held to the closed form
                    u0 (-1)^k e^(1/2) / sqrt(k!) within the quadrature's own
                    error; the PCE tables at 4 dimensions, degree 6 (210
                    terms); fit_pdf of 10^7 2-D Gaussian samples at levels
                    5, 6, 7 (769 basis functions); B1 on the collocation
                    operator against its plain version; gates: CG meets
                    rtol, coefficients within tolerance, mass matrix = I to
                    1e-12, triple products symmetric, the sparse grid's L2
                    error falls from level 5 to 7, B1 launched.

Slice 10, the multi-device layer and the 3-D patch operator, after phase
45 (``run_slice10``; constants DIST_*, PATCH3D_*).  The CUDA and native
libraries are built before any rank starts.  DIST_RANKS = 4 rank processes
share the one card over gloo (``parallel.ranks.launch``: spawn, a file
store, a join timeout; a failed or hung rank fails the phase); each phase
line names the backend and that the ranks share the card:

46. dist_partition — RCB, graph and contiguous partitions of the
                    gambit-poisson-256 mesh into 4 (native library
                    required): edge cut, ghosts per rank, the Q2 halo
                    plan's m and offsets, native and numpy seconds;
47. dist_halo     — the halo SpMV on 4 ranks, B1 per rank (interior and
                    boundary sliced-ELL blocks) and the ELL gather, through
                    all_to_all (auto: gloo's send/recv refuse CUDA tensors,
                    so ppermute waits for NCCL on cards of their own), with
                    and without overlap, on the cavity-128 Jacobian (f32, f64) and the
                    263,169-dof Poisson operator (f64); gates against the
                    global B1: f32 1e-5, f64 1e-12 of max(|A||x|); each
                    rank's B1 blocks against their plain version, timed one
                    rank at a time, the rank's whole product beside one
                    CSR product of its block and the interior launch
                    beside the CSR of its own columns; exchange and SpMV
                    ms per rank;
48. dist_step     — make_sharded_step on 4 ranks against world size 1:
                    263,169-dof Poisson, Galerkin V-cycle (4 levels,
                    Jacobi), CG to 1e-8, f64 (equal iterations, solutions
                    within 1e-9); the dryrun_multichip cavity step at
                    cavity-64 (within 1e-8); the production step's seconds
                    (cold, warm), then an instrumented step (same
                    solution) with seconds per iteration in exchange,
                    local matvec and reductions; since slice 11 also
                    dryrun-vanka (the same cavity with Vanka blocks on
                    both levels) and fsi-vanka-aux (one K-cycle step of
                    the transient fsi-bed at 78,852 dofs, f64: R·A·P
                    transfers, Vanka on every level, the old fields as aux
                    fields), each with equal iterations and within 1e-9;
49. dist_patch    — poisson-patch-1M's operator over 4 slabs of patches,
                    B2 on each slab, skeleton closed by one all_reduce;
                    gate against the global B2 at 1e-5 of max(|A||x|);
                    each slab's B2 beside one CSR product of the slab;
50. dist_markers  — markers-256's 2^20 markers, 10 RK4 steps over 4 ranks
                    with all_to_all migration: migrations and drops (0)
                    per step; elements equal and positions within 1e-12 of
                    the one-rank cloud;
51. nccl_world1   — the dist_halo and dist_step code at world size 1 on
                    NCCL (it initialises and reduces; no multi-card test);
52. patch3d       — operator="patch" Poisson on
                    PatchedMultiLevelMesh(unit_box((6,6,6), "hex"), 4)
                    (finest 48^3 elements, 912,673 dofs, float32): the 3-D
                    patch matvec against B1 on the ELL operator of the same
                    matrix at the 117,649-dof level (1e-5 relative; the
                    finest level's ELL set-up took 436 s on the host of
                    an H100 machine), the
                    solve's iterations and
                    seconds, and unit_box((2,2,2)) at 3 levels on the card
                    (float32) against the host (float64).

Slice 11, the System diagnostics, the profiler trace, the writers and
the checkpoints, on the solved cavity-128 right after phase 3
(``run_slice11``; the state the solve left stays as it is):

3a. diagnostics   — System.profile_step(-1, reps=3): assembly, coarsening
                    and solve-step seconds, the B1 launches of the solve
                    steps (> 0), dofmap_size of u, v, p equal to the
                    solution's and the dof maps' sizes, peak device bytes;
3b. trace         — one Newton step under utils.telemetry.trace: the
                    Chrome trace must name B1's kernel (sell_spmv_kernel);
3c. writers       — VTKWriter and GMVWriter of the finest u, v, p
                    (seconds, bytes); the GMV read back and the VTU parsed
                    back equal nodal_field exactly; XDMF only where h5py
                    is installed (find_spec; the card's machine has none);
3d. checkpoint    — capture_solution, CheckpointManager.save, a fresh
                    cavity-128 System, restore: the arrays equal exactly;
                    one solve step from each: their ends within
                    CKPT_STEP_RTOL; one from each kicked state (free dofs
                    scaled by 1 + CKPT_KICK): updates within
                    CKPT_UPDATE_RTOL.

Slice 12, the golden apps and the ten examples, after phase 28
(``run_slice12``; constants CHANNEL_*, FSI_CHANNEL_*, EX08_DISK_N, EX03_*,
EXAMPLES_*).  The reference meshes (nsbenc.neu, fsifirst.neu, disk.neu)
are absent: ``channel_neu`` writes a Turek-style channel (2.2 x 0.41, a
square obstacle near (0.2, 0.2), optionally a beam behind it; not the
benchmark geometry) and ``disk_neu`` the unit disk, and the apps and ex08
read those files:

53. channel_setup, channel_kernel, channel_main — ns-channel, the JAX main
                    path's own builder: apps.ns_bench.make_ns_system
                    (levels 4, rtol 1e-4, interleave=True, then operator
                    "bell", as bench.py's bench_newton_step) on the 44 x 8
                    channel (finest 22,272 quads, U, V Q2 and P P1dc:
                    246,784 dofs), float32, the F-cycle ratchet with up to
                    CHANNEL_NEWTON Newton steps a level; B1 on the channel
                    Jacobian at the initial state against its plain version
                    (f32, bf16, f64 random; cold time, bound, CSR, fill);
                    Newton steps, GMRES iterations, seconds and ||R(u)|| by
                    level, B1 launches, peak bytes; then
                    make_temperature_system in the solved velocity (float64)
                    with its iterations, residual and ||T||; gates: every
                    linear solve meets rtol, the finest ||R(u)|| falls
                    10^3x from the initial guess, the temperature meets
                    1e-10, B1 launched;
54. fsi_channel   — apps.fsi_bench.make_fsi_system on the channel with the
                    beam (group 5), FSI_CHANNEL_LEVELS levels (27,344
                    dofs; see FSI_CHANNEL_LIN_ITERS for why not 3),
                    K-cycle, the reference's inexact Newton (one FGMRES(20)
                    cycle a step), operator "bell", float64: set-up and
                    solve seconds, Newton steps, iterations and ||R(u)|| by
                    level, the beam tip's DY, B1 launches; gates: the
                    finest ||R(u)|| falls 10^3x, det F > 0 on the beam, B1
                    launched;
55. examples      — femus_tpu_torch.examples ex01-ex10 at their JAX
                    defaults on the card in float64 (ex08 on disk_neu's disk
                    of EX08_DISK_N coarse cells at EX_LEVELS 3, EX_STEPS 8;
                    ex10 on EX10_RANKS ranks), their printed
                    lines and seconds; gates: the claim each prints (L2
                    orders, convergence, capture, the sinking block, finite
                    PCE moments, ex08-ex10's own assertions; ex03 see
                    EX03_DEFAULT_EPS), and ex01, ex02, ex04 and ex07 on the
                    host agree with the card to EXAMPLES_HOST_RTOL.

Then the card's name and power limit, the kernel table as one JSON line,
and the final status line.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
F64_FLOPS_PER_S = 34e12          # H100 SXM float64, outside the tensor cores
# the slice configurations: coarsest mesh cells per side, mesh levels
COARSE_CELLS = 16                 # cavity-128
LEVELS = 4
PATCH_COARSE, PATCH_LEVELS = 32, 5    # poisson-patch-1M
ELAST_COARSE, ELAST_LEVELS = 16, 5    # elasticity-patch
LATTICE_N = 512                       # poisson-lattice-512
SWEEP_WARM, SWEEP_STEPS = 10, 400
# max nodal error of the float32 poisson-patch-1M solve: 2x the float32
# floor, 0.0123 for an exact solve of the card's float32 data
# (tools/torch_patch_f32_limit.py --device cuda); the solve reaches 0.0120
# and 30 more GMRES iterations leave it there
# (tools/torch_patch_residual.py); a wrong operator or an unconverged
# solve gives O(1)
PATCH_ERR_MAX = 2.5e-2
# largest true preconditioned residual ||M (b - A x)|| over the solve's
# target rtol * ||M b|| that a float32 patch solve may end with: further
# GMRES cycles do not push it below the float32 floor, which
# tools/torch_patch_residual.py measured on the card at 5.7-27x (Poisson)
# and 16-179x (elasticity, up to 300x in other runs); a solve that stopped
# with no iteration sits at 1e6x
RESIDUAL_SLACK = {"patch_main": 100.0, "patch_elasticity": 1000.0}
# fsi-bed-64 (steady; fsi-bed-128 at 4 levels before the whole run's
# clock needed the room) and fsi-bed-transient-64: coarsest cells per side,
# mesh levels of each; the problem and its constants (FSI_*) are
# femus_tpu_torch.parallel.cases.fsi_bed's
FSI_COARSE, FSI_LEVELS, FSI_TRANSIENT_LEVELS = 16, 3, 3
# FSI_TRANSIENT_STEPS: 2 since slice 11 (3 before; cut for the run's clock)
FSI_TRANSIENT_STEPS = 2
# the FSI phases solve in float64: in float32 the K-cycle FGMRES's true
# residual stalls far above its estimate, the Newton corrections floor
# near 1e-5 and a Vanka block of the small reference case factors with an
# exact zero pivot (PERF.md, section 6; tools/torch_fsi_precision.py)
FSI_DTYPE = torch.float64


# slice 6: oc-distributed-128 and oc-boundary-128 (unit_box((16,16)), 4
# levels, finest 128x128, 3 x 66,049 dofs) and oc-theta-64 (3 levels);
# float32, linear rtol 1e-6, OC_NEWTON Newton steps per KKT solve (the KKT
# system is linear: the second step reports the first one's accuracy)
OC_COARSE, OC_LEVELS, OC_THETA_LEVELS = 16, 4, 3
OC_ALPHA, OC_BOUNDARY_ALPHA, OC_CTRL_GROUP = 1e-3, 1e-2, 2
OC_BOUNDS, OC_PDAS_ITERS = (0.5, 8.0), 5
OC_DTYPE, OC_RTOL, OC_MAX_OUTER, OC_NEWTON = torch.float32, 1e-6, 10, 2
# largest |control| off the control boundary over its largest value on it:
# the eliminated control rows keep corrections at the solve's tolerance
# (their coarse-grid transfers are the ones built before the elimination,
# as in the reference)
OC_OFF_GC_MAX = 1e-3
# the field-split cavity (unit_box((128,128)), 148,739 dofs) and the
# FGMRES(50) restarts each preconditioner gets
FIELDSPLIT_N, FIELDSPLIT_RESTARTS = 128, 6
# the convergence study: unit_box((4,4)) through 6 levels (finest 128x128)
CONV_COARSE, CONV_LEVELS = 4, 6


# slice 7: amr-lshape, the corner singularity of tests/test_amr.py from
# box((32, 32)) on (-1, 1)^2 minus (0, 1)^2 (768 quads): AMR_CYCLES cycles
# of solve_mg_amr -> Kelly -> refine the worst AMR_FRACTION; MG-CG to the
# relative AMR_TOL in float64.  Up to AMR_CONFORMING_MAX_DOFS dofs (the
# scale of tests/test_mg_amr.py) every cycle's CG takes at most
# AMR_MAX_ITERS iterations, and the last such cycle is held against the
# single-level diagonal CG of solve_conforming; beyond it the multigrid
# across AMR levels takes 0-3 more iterations per cycle, in the JAX
# package too (15, 18, 18 at 21k, 34k, 54k dofs on the host,
# tools/amr_lshape_iterations.py; 21 at 87k), so there a cycle may take
# at most AMR_ITER_GROWTH more than the one before
# AMR_CYCLES: a cut in depth for the run's clock (each cycle's host
# set-up grows with the chain)
AMR_COARSE, AMR_CYCLES, AMR_FRACTION = 32, 5, 0.2
AMR_TOL, AMR_MAX_ITERS, AMR_CONFORMING_MAX_DOFS = 1e-10, 15, 20000
AMR_ITER_GROWTH = 4


# slice 8: boussinesq-cavity-128, the de Vahl Davis (1983) differentially
# heated cavity at Ra = 1e4, Pr = 0.71 on unit_box((16,16)), 4 levels
# (finest 128x128, u, v, T Q2 and p P1dc: 247,299 dofs), float32, linear
# rtol 1e-4, up to BOUS_NEWTON Newton steps from zero; the benchmark's Nu on
# the hot wall, u_max on x = 0.5 and v_max on y = 0.5 (velocities in units
# of kappa / L: the form's free-fall velocities times sqrt(Ra Pr)), each
# held to BOUS_TOL relative
BOUS_RA, BOUS_PR, BOUS_NEWTON = 1e4, 0.71, 8
BOUS_BENCH = {"nu": 2.243, "u_max": 16.178, "v_max": 19.617}
BOUS_TOL = 0.01
# forms-128: the coupled biharmonic and Willmore flow of a graph from
# unit_box((8,8)) over FORMS_LEVELS levels (finest 128x128, 2 x 66,049
# dofs) and one level fewer for the L2 order, float64; the sphere cap of
# tests/test_willmore.py has radius WILLMORE_R
FORMS_COARSE, FORMS_LEVELS, WILLMORE_R = 8, 5, 1.2
# surface-cylinder-256 (263,169 dofs) and the 128x128 mesh for the order;
# conformal-128 (132,098 dofs); mixed-poisson-128 and the 64x64 mesh for
# the order; sw-128 (lake at rest: 198,147 dofs; tracer: 66,049);
# nonlocal-64 (4,225 dofs, 1.30 M nonzeros, rows of up to 357)
SURF_N, CONF_N, MIXED_N = 256, 128, 128
# SW_LAKE_STEPS: a cut in depth for the run's clock (the lake at rest
# stays at rest; two steps show that a step keeps it)
SW_N, SW_DT, SW_LAKE_STEPS, SW_TRACER_STEPS = 128, 0.01, 2, 40
NONLOCAL_N, NONLOCAL_DELTA = 64, 0.1


# slice 9: gambit-poisson-256 (a unit_box((32,32)) Q2 mesh written as a
# Gambit .neu file with the groups NEU_GROUPS, read back, NEU_LEVELS levels:
# finest 256x256, 263,169 dofs); markers-256 (2^20 markers in a disk on
# unit_box((256,256)), MARKERS_TURN of a revolution at MARKERS_STEPS RK4
# steps a revolution, a host subset of MARKERS_SUBSET; ex05's capture on
# MAGNETIC_COUNT markers);
# mpm-block-128 (the explicit block at 128x128, MPM_STEPS steps of MPM_DT
# under gravity MPM_G; the 8x8 block MPM_REF_STEPS steps on card and host,
# held to MPM_REF_TOL: the card's atomics reorder the P2G sums, ~1e-15 a
# step); mpm-fsi-sinking-64 (ex06 at n = 64: 37,507 dofs, MPM_FSI_STEPS
# implicit steps, up to MPM_FSI_NEWTON Newton iterations each);
# projection-256 (unit_box((256,256)) Q2 onto unit_box((200,200)) Q2
# shifted by PROJ_SHIFT); uq-pce-128 (ex07 at 128x128 Q2, UQ_NQ Hermite
# nodes, PCE degree UQ_DEG; fit_pdf of UQ_SAMPLES samples at UQ_SG_LEVELS:
# at 10^6 samples the level-7 estimate's sampling error puts its L2 error
# above level 5's, 0.00373 against 0.00239 in a host float64 run, and at
# 10^7 below it, 0.00133 against 0.00175)
NEU_COARSE, NEU_LEVELS, NEU_GROUPS = 32, 4, (1, 2, 3, 4)
# (cuts in depth for the run's clock: mpm-fsi-sinking-64 takes
# MPM_FSI_STEPS steps; markers-256 cannot take fewer steps a revolution, at
# 200 the 4-hop walk loses a third of the markers, so it runs a quarter
# turn, MARKERS_TURN; ex05's capture on MAGNETIC_COUNT markers runs
# MAGNETIC_STEPS steps of 0.02)
MARKERS_N, MARKERS_COUNT, MARKERS_STEPS = 256, 1 << 20, 400
MARKERS_SUBSET, MAGNETIC_COUNT, MAGNETIC_STEPS = 4096, 100_000, 50
MARKERS_TURN = 0.25
MPM_N, MPM_STEPS, MPM_DT, MPM_G = 128, 500, 2.5e-4, -1.0
MPM_REF_STEPS, MPM_REF_TOL = 50, 1e-10
MPM_FSI_N, MPM_FSI_STEPS, MPM_FSI_NEWTON = 64, 1, 8
PROJ_SRC, PROJ_DST, PROJ_SHIFT = 256, 200, (0.1, -0.05)
UQ_N, UQ_NQ, UQ_DEG = 128, 7, 4
UQ_SAMPLES, UQ_SG_LEVELS = 10 ** 7, (5, 6, 7)


# the measured keys of a row of the final kernel table
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries ``t_s``, the seconds since
    the script started (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def cavity_system(coarse: int, levels: int, device, dtype, rtol: float,
                  max_nonlinear: int, **config):
    """The lid-driven cavity through the port's public entry points;
    ``config`` overrides fields of its SolverConfig."""
    from femus_tpu_torch.assembly.forms import navier_stokes
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import NonLinearImplicitSystem

    def bc(var, x, grp, t):
        if var == "p":
            return (False, 0.0)
        if var == "u" and abs(x[1] - 1.0) < 1e-9:
            return (True, 1.0)                   # the moving lid
        return (True, 0.0)

    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    rcm_reorder_hierarchy(ml_mesh)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.add_solution("v", "biquadratic")
    ml_sol.add_solution("p", "disc_linear")
    for n in ("u", "v", "p"):
        ml_sol.initialize(n)
    ml_sol.attach_bc(bc)
    for n in ("u", "v", "p"):
        ml_sol.generate_bdc(n)
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(NonLinearImplicitSystem, "NS")
    sys_.add_unknown("u", "v", "p")
    sys_.set_assembly(navier_stokes(("u", "v"), "p",
                                    pres_family="disc_linear", nu=0.01))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.mg_type = "V"
    cfg.rtol = rtol
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.max_nonlinear = max_nonlinear
    for key, value in config.items():
        if not hasattr(cfg, key):
            raise AttributeError(f"SolverConfig has no field {key!r}")
        setattr(cfg, key, value)
    sys_.init(device=device, dtype=dtype)
    return sys_, ml_sol


def patch_system(problem: str, coarse: int, levels: int, device, dtype,
                 rtol: float):
    """A patch-operator linear system through the port's public entry
    points: "poisson" or "elasticity" (see the module docstring)."""
    from femus_tpu_torch.assembly.forms import elasticity, poisson
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import PatchedMultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    pi = np.pi
    if problem == "poisson":
        names = ["u"]
        form = poisson("u", rhs=lambda x: 2 * pi ** 2 * torch.sin(pi * x[:, 0])
                       * torch.sin(pi * x[:, 1]))
        bc = lambda var, x, grp, t: (True, 0.0)          # noqa: E731
    else:
        names = ["DX", "DY"]
        form = elasticity(("DX", "DY"), lam=1.2, mu=0.8, force=lambda x:
                          torch.stack([0.0 * x[:, 0], -1.0 + 0.0 * x[:, 1]],
                                      1))
        bc = lambda var, x, grp, t: (grp == 1, 0.0)       # noqa: E731
    ml_mesh = PatchedMultiLevelMesh(unit_box((coarse, coarse)), levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    for n in names:
        ml_sol.add_solution(n, "biquadratic")
        ml_sol.initialize(n)
    ml_sol.attach_bc(bc)
    for n in names:
        ml_sol.generate_bdc(n)
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(LinearImplicitSystem, problem)
    sys_.add_unknown(*names)
    sys_.set_assembly(form)
    cfg = sys_.config
    cfg.operator = "patch"
    cfg.coarse_op = "rediscretize"
    cfg.smoother = "chebyshev"
    cfg.mg_type = "V"
    cfg.rtol = rtol
    sys_.init(device=device, dtype=dtype)
    return sys_, ml_mesh, ml_sol, names


def reset_launches() -> None:
    from femus_tpu_torch.systems.system import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0


def time_ms(fn, reps: int = 60, warm: int = 5) -> float:
    """Median device time of one call over ``reps`` back-to-back calls.
    An event is recorded between consecutive calls; the host enqueues
    faster than the card drains, so each interval is one call's device
    time (launch gaps excluded)."""
    for _ in range(warm):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(reps)]))


_flush_buffer = []


def time_cold_ms(fn, reps: int = 30) -> float:
    """Median device time of one call that finds the 50 MB L2 cold: a
    512 MB buffer is read through before each call (read, not written, so
    the cache is left full of clean lines and the call pays for no
    write-back), and an event pair brackets the call alone.  What a caller
    sees whose other kernels have pushed the operator out of the cache
    between two matvecs.  The host enqueues the events and the call while
    the card is still reading the buffer, so host time stays out of the
    interval; ``time_ms`` (back to back) reads the host's enqueue rate
    instead wherever a call is shorter on the card than in Python, and
    lets an operator near the L2's size stay partly resident."""
    if not _flush_buffer:
        _flush_buffer.append(torch.zeros(128 << 20, dtype=torch.float32,
                                         device="cuda"))
    fn()
    times = []
    for _ in range(reps):
        _flush_buffer[0].sum()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def phase_build(card: str):
    from femus_tpu_torch._cuda_build import KERNEL_SOURCES, build
    t0 = time.perf_counter()
    logs = build(KERNEL_SOURCES)
    report = {src: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln][:8]
              for src, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sources": KERNEL_SOURCES,
          "ptxas": report})


def phase_kernel(sys_, phase: str = "kernel",
                 dtypes=(("f32", torch.float32),
                         ("bf16", torch.bfloat16))) -> dict:
    """B1 against its plain version on a main path's fine operator at its
    initial state, in the device plan the solve itself uses: values in each
    of ``dtypes`` from the assembly, float64 on random data."""
    a = sys_.assemblers[-1]
    u0 = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype,
                         device=sys_.device)
    _, data = a.make_assemble_fn(pass_tables=True)(
        u0, a.device_tables_cached())
    return b1_rows(data, a.pattern, sys_._bell_dev(a.pattern), phase, dtypes)


def b1_held(op, xv, rtol: float) -> dict:
    """Kernel B1 against its plain version on the frame operator ``op``
    and vector ``xv``: the largest difference, within ``rtol`` of
    max(|A| |x|), and bit-for-bit repeats."""
    from femus_tpu_torch.algebra import bell

    y_k = bell.spmv_bell_cuda(op, xv)
    torch.cuda.synchronize()
    y_p = bell._matvec_plain_frame(op, xv)
    absop = bell.BellOp(op.vals.abs(), op.dev)
    scale = float(bell._matvec_plain_frame(absop, xv.abs()).abs().max())
    err = float((y_k - y_p).abs().max())
    return {"max_abs_err": err, "scale": scale, "rtol": rtol,
            "ok": err <= rtol * scale,
            "repeats_bit_for_bit": bool(torch.equal(
                bell.spmv_bell_cuda(op, xv), y_k))}


def b1_rows(data, pattern, dev, phase: str, dtypes) -> dict:
    """B1 against its plain version on the ELL operator ``data`` of
    ``pattern`` in the device plan ``dev``: values in each of ``dtypes``,
    float64 on random data; cold time, plain time, HBM bound and one
    torch.sparse CSR matvec of the same matrix in the same types."""
    from femus_tpu_torch.algebra import bell

    n, nnz = dev.n, int(pattern.nnz)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(n, generator=gen, dtype=torch.float32).cuda()
    out = {"n": n, "nnz": nnz, "format": "sell-32-sigma",
           "sigma": dev.sigma, "n_slices": dev.n_slices,
           "slots": dev.total, "fill": dev.fill,
           "identity_frame": dev.perm is None}

    rows = {}
    valid = torch.as_tensor(pattern.valid, device="cuda")
    cols = torch.as_tensor(pattern.cols, dtype=torch.int64, device="cuda")
    counts = valid.sum(dim=1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    for name, dt in dtypes:
        op = bell.relayout_ell(dev, data, dtype=dt, device="cuda")
        # float64 values multiply a float64 x (the FSI solve's own types)
        xv = x.double() if dt == torch.float64 else x
        row = b1_held(op, xv, 1e-12 if dt == torch.float64 else 1e-5)
        isz, xsz = op.vals.element_size(), xv.element_size()
        peak = F64_FLOPS_PER_S if dt == torch.float64 else F32_FLOPS_PER_S
        # the bound: what the matvec itself needs, each nonzero's value and
        # int32 column id, x and y once, and two flops a nonzero
        nnz_bytes = nnz * (isz + 4) + 2 * n * xsz
        t_bytes = nnz_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * nnz / peak * 1e3
        # what the kernel's plan makes it read and write: every slot of
        # the slices (the fill's padding too), slice pointers, the row
        # order, x and y, each once
        slot_bytes = (dev.total * (isz + 4) + (dev.n_slices + 1) * 4
                      + dev.n_slices * 32 * 4 + 2 * n * xsz)
        t_slots = max(slot_bytes / HBM_BYTES_PER_S,
                      2 * dev.total / peak) * 1e3
        # the operator (52 MB in float32) is about the size of the L2 and
        # a call is shorter than its Python wrapper on a slow host: the
        # reported time is the cold one, in turns (kernel, plain, kernel)
        first_ms = time_cold_ms(lambda: bell.spmv_bell_cuda(op, xv))
        plain_ms = time_ms(lambda: bell._matvec_plain_frame(op, xv),
                           reps=30)
        ms = time_cold_ms(lambda: bell.spmv_bell_cuda(op, xv))
        row.update({"ms": ms, "first_ms": first_ms, "plain_ms": plain_ms,
                    "back_to_back_ms": time_ms(
                        lambda: bell.spmv_bell_cuda(op, xv)),
                    "bytes": nnz_bytes,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "pct_of_bound": 100.0 * max(t_bytes, t_ops) / ms,
                    "slot_bytes": slot_bytes,
                    "operator_bytes": slot_bytes - 2 * n * xsz,
                    "bound_slots_ms": t_slots,
                    "pct_of_slots_bound": 100.0 * t_slots / ms})
        if dt in (torch.float32, torch.float64):
            # library yardstick: one torch.sparse CSR matvec of the same
            # matrix in the same types
            csr = torch.sparse_csr_tensor(crow, cols[valid],
                                          data.to(dt)[valid],
                                          check_invariants=False,
                                          size=(n, n))
            if dev.perm is None:
                row["library_err"] = float(
                    (csr @ xv - bell.spmv_bell_cuda(op, xv)).abs().max())
            row["library_ms"] = time_cold_ms(lambda: csr @ xv)
            row["library_back_to_back_ms"] = time_ms(lambda: csr @ xv)
            del csr
        rows[name] = row
        del op
    # float64 values and x on seeded random data in the same pattern
    rnd = torch.randn(valid.shape, generator=gen, dtype=torch.float64
                      ).cuda() * valid
    op64 = bell.relayout_ell(dev, rnd, device="cuda")
    rows["f64_random"] = b1_held(
        op64, torch.randn(n, generator=gen, dtype=torch.float64).cuda(),
        1e-12)
    del op64, rnd
    out.update(rows)
    emit({"phase": phase, **out})
    if not all(r["ok"] and r["repeats_bit_for_bit"] for r in rows.values()):
        raise AssertionError("B1 disagrees with its plain version")
    return {**rows[dtypes[0][0]], "fill": dev.fill, "n": n, "nnz": nnz}


def phase_main(sys_, ml_sol) -> int:
    from femus_tpu_torch.systems.system import launch_counts

    reset_launches()
    _flush_buffer.clear()             # the timing buffer is no part of a solve
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()["bell_spmv"]
    peak = torch.cuda.max_memory_allocated()
    for h in sys_.history:
        emit({"phase": "newton_step", "it": h["newton_it"],
              "seconds": h["seconds"], "gmres_iters": h["lin_iters"],
              "lin_res": h["lin_res"], "lin_target": h["lin_target"],
              "converged": h["converged"],
              "res_norm": h["res_norm"],
              "kernel_launches": h["kernel_launches"], "eps": h["eps"]})
    hist = sys_.history
    drop = hist[0]["res_norm"] / max(hist[-1]["res_norm"], 1e-300)
    on_cuda = _all_on_cuda(sys_)
    fields_ok = all(np.all(np.isfinite(ml_sol.sol[-1][n]))
                    for n in ("u", "v", "p"))
    emit({"phase": "main", "wall_s": wall, "newton_steps": len(hist),
          "kernel_launches": launch_counts(), "res_norm_drop": drop,
          "all_converged": all(h["converged"] for h in hist),
          "tensors_on_cuda": on_cuda, "fields_finite": fields_ok,
          "peak_device_bytes": peak,
          "n_dofs": sys_.assemblers[-1].n_dofs,
          "routing": sys_.solver_info()["routing"]})
    if not all(h["converged"] for h in hist):
        raise AssertionError("a linear solve missed its rtol")
    if not drop >= 1e3:
        raise AssertionError(f"||R(u)|| fell only {drop:.3g}x")
    if launches <= 0:
        raise AssertionError("the main path launched no BELL kernel")
    if not (on_cuda and fields_ok):
        raise AssertionError("tensors off the card or non-finite fields")
    return launches


def _all_on_cuda(sys_) -> bool:
    tensors = []
    for a in sys_.assemblers:
        t = a.device_tables_cached()
        tensors += [v for v in t.values() if torch.is_tensor(v)]
        if "patch_routing" in t:
            r = t["patch_routing"]
            tensors += [r.face_code, r.corner_vert, r.edge_sides,
                        r.vert_sides]
        tensors += [x for pair in t["tabs"].values() for x in pair]
    for P, R, sched in sys_.transfers:
        tensors += [P.data, P.cols, R.data, R.cols]
        if sched is not None:
            tensors += [sched.src, sched.dst, sched.coeff]
    for rs in sys_._rsol:
        if rs is not None:
            tensors += [rs[0].data, rs[0].cols, rs[1]]
    for dev in sys_._bell_plans.values():
        tensors += [dev.cols, dev.slice_ptr, dev.row_order, dev.src,
                    dev.diag_slot]
    return all(t.is_cuda for t in tensors)


def _profiled(fn) -> tuple:
    """``fn()`` under torch.profiler: (its result, wall seconds, device
    time by kernel and the device's busy share of the call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return out, {"device_busy_s": busy_us * 1e-6,
                 "idle_share": 1.0 - busy_us * 1e-6 / wall,
                 "n_kernels": len(kernels),
                 "top": [{"name": n[:60], "calls": c, "ms": us * 1e-3}
                         for n, (c, us) in top]}, wall


def phase_profile(sys_, u, label: str) -> None:
    """One more solve step from state ``u`` under torch.profiler: device
    time by kernel and the device's busy share of the step."""
    step = sys_.step_fn(-1)
    step(u)                                   # warm
    out, rep, wall = _profiled(lambda: step(u))
    emit({"phase": "profile", "system": label, "step_wall_s": wall,
          "gmres_iters": out.lin_iters, **rep})


def phase_lattice_profile(ops) -> None:
    """One more Chebyshev-CG solve on the lattice operator under
    torch.profiler (the solve of lattice_main, already warm)."""
    (_, info, _), rep, wall = _profiled(lambda: lattice_cg(ops))
    emit({"phase": "profile", "system": "poisson-lattice-512",
          "solve_wall_s": wall, "cg_iters": info.iters, **rep})


def phase_reference() -> None:
    """Small cavity: the card's float32 solve against the host's float64."""
    fields = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        sys_, ml_sol = cavity_system(8, 2, device, dtype, rtol=1e-6,
                                     max_nonlinear=4)
        sys_.solve()
        fields[device] = np.concatenate([ml_sol.sol[-1][n]
                                         for n in ("u", "v", "p")])
    ref = fields["cpu"]
    rel = float(np.linalg.norm(fields["cuda"] - ref) / np.linalg.norm(ref))
    emit({"phase": "reference", "n_dofs": int(ref.size), "rel_diff": rel})
    if not rel < 1e-3:
        raise AssertionError(f"card and host solutions differ: {rel:.3g}")


def patch_kernel_work(H: int, P: int, isz: int, n: int, tables: int,
                      nv: int = 1) -> tuple:
    """(bytes, flops) kernel B2 must move and do for one matvec of a patch
    operator of ``nv`` variables of ``n`` rows each: the weights whose
    window position lies inside the H x H lattice (a weight on the zero
    ring multiplies zero and is not read), each read once; x read once and
    y written once; the ``tables`` int32 entries of the index routing read
    once.  Padding patches beyond P are not counted; the line and corner
    partials between the two launches are the kernel's own and no part of
    the least work."""
    from femus_tpu_torch.algebra.patchstencil import OFFSETS
    weights = nv * nv * P * sum((H - abs(di)) * (H - abs(dj))
                                for di, dj in OFFSETS)
    return (weights + 2 * nv * n) * isz + 4 * tables, 2 * weights


def _patch_held(op, x, rtol: float) -> dict:
    """The whole CUDA matvec of ``op`` against its plain version."""
    import dataclasses

    from femus_tpu_torch.algebra import patchstencil as ps
    y_k = ps.spmv_patch_cuda(op, x)
    torch.cuda.synchronize()
    y_p = ps._patch_matvec_plain(op, x)
    scale = float(ps._patch_matvec_plain(
        dataclasses.replace(op, wt=op.wt.abs()), x.abs()).max())
    err = float((y_k - y_p).abs().max())
    return {"max_abs_err": err, "scale": scale, "rtol": rtol,
            "ok": err <= rtol * scale,
            "repeats_bit_for_bit": bool(torch.equal(
                ps.spmv_patch_cuda(op, x), y_k))}


def _matvec_launches(op, x) -> dict:
    """Device kernels of one ``op.matvec(x)``, by torch.profiler over 20
    of them (the profiler may miss the first few records, so the count is
    taken per recorded stencil launch)."""
    op.matvec(x)
    _, rep, _ = _profiled(lambda: [op.matvec(x) for _ in range(20)])
    names = [k["name"] for k in rep["top"]]
    stencils = sum(k["calls"] for k in rep["top"]
                   if "patch_stencil_kernel" in k["name"])
    return {"launches_per_matvec": rep["n_kernels"] / max(stencils, 1),
            "kernels": names,
            "other_kernels": sum("patch_stencil_kernel" not in n
                                 and "patch_combine_kernel" not in n
                                 for n in names),
            "matmul_kernels": sum("gemm" in n.lower() or "gemv" in n.lower()
                                  for n in names)}


def phase_patch_kernel(psys, esys) -> dict:
    """B2 against its plain version on the finest eliminated operators
    (scalar Poisson, block elasticity) and on random weights."""
    import dataclasses

    from femus_tpu_torch.algebra import patchstencil as ps
    from femus_tpu_torch.assembly.engine import Assembler

    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    # scalar: the poisson-patch-1M fine operator
    a = psys.assemblers[-1]
    u0 = torch.zeros(a.n_dofs, dtype=torch.float32, device="cuda")
    _, data = a.make_assemble_fn(pass_tables=True)(
        u0, a.device_tables_cached())
    op = a.op_with(data)
    x = torch.randn(op.n_rows, generator=gen, dtype=torch.float32).cuda()
    row = _patch_held(op, x, 1e-5)
    H, P, Pp, E = op.meta[:4]
    rt = op.routing
    tables = sum(t.numel() for t in (rt.face_code, rt.corner_vert,
                                     rt.edge_sides, rt.vert_sides))
    isz = op.wt.element_size()
    nbytes, flops = patch_kernel_work(H, P, isz, op.n_rows, tables)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    scratch = (torch.empty((1, E, 4, Pp), dtype=x.dtype, device="cuda"),
               torch.empty((1, 4, Pp), dtype=x.dtype, device="cuda"))
    # cold times (a call can be shorter than its Python wrapper), in turns:
    # whole matvec, the two launches alone, plain, whole matvec
    first_ms = time_cold_ms(lambda: op.matvec(x))
    stencil_ms = time_cold_ms(lambda: ps.spmv_patch_cuda(
        op, x, stages=ps.STENCIL, scratch=scratch))
    combine_ms = time_cold_ms(lambda: ps.spmv_patch_cuda(
        op, x, stages=ps.COMBINE, scratch=scratch))
    plain_ms = time_ms(lambda: ps._patch_matvec_plain(op, x), reps=20)
    ms = time_cold_ms(lambda: op.matvec(x))
    # library yardstick: one torch.sparse CSR matvec of the same matrix,
    # from the port's own ELL assembly of the same mesh (same Dirichlet rows)
    e = Assembler(a.mesh, a.unknowns, quad_order=a.quad_order,
                  dtype=torch.float32, device="cuda")
    e.set_volume_form(a.volume_form)
    e.set_dirichlet(a.dirichlet_mask)
    _, edata = e.make_assemble_fn()(u0)
    valid = torch.as_tensor(e.pattern.valid, device="cuda")
    cols = torch.as_tensor(e.pattern.cols, dtype=torch.int64, device="cuda")
    counts = valid.sum(dim=1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    csr = torch.sparse_csr_tensor(crow, cols[valid], edata[valid],
                                  check_invariants=False,
                                  size=(e.n_dofs, e.n_dofs))
    y_mv = op.matvec(x)
    y_lib = csr @ x
    nnz = int(e.pattern.nnz)
    nnz_bytes = nnz * (isz + 4) + 2 * op.n_rows * isz
    t_nnz = nnz_bytes / HBM_BYTES_PER_S * 1e3
    # a layout that stored the nonzeros' values alone (no column ids, no
    # structural zeros): the yardstick for the kernel's next step
    t_val = (nnz * isz + 2 * op.n_rows * isz) / HBM_BYTES_PER_S * 1e3
    row.update({
        "H": H, "P": P, "Pp": Pp, "n": op.n_rows, "nnz": nnz,
        "ms": ms, "first_ms": first_ms, "matvec_ms": ms,
        "back_to_back_ms": time_ms(lambda: op.matvec(x)),
        "stencil_ms": stencil_ms, "combine_ms": combine_ms,
        "plain_ms": plain_ms,
        **_matvec_launches(op, x),
        "library_ms": time_cold_ms(lambda: csr @ x),
        "library_back_to_back_ms": time_ms(lambda: csr @ x),
        "library_vs_patch_matvec": float((y_lib - y_mv).abs().max()),
        "library_vs_patch_scale": float(y_lib.abs().max()),
        "bytes": nbytes, "slab_bytes": op.wt.numel() * isz,
        "routing_table_bytes": 4 * tables,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "pct_of_bound": 100.0 * max(t_bytes, t_ops) / ms,
        "nnz_bytes": nnz_bytes, "bound_nnz_ms": t_nnz,
        "pct_of_nnz_bound": 100.0 * t_nnz / ms, "bound_values_ms": t_val})
    out["poisson"] = row
    del csr, e, edata, valid, cols
    # the same shapes with seeded random weights, float32 and float64 (no
    # structural zeros: every weight inside the lattice counts)
    for name, dt, rtol in (("random_f32", torch.float32, 1e-5),
                           ("random_f64", torch.float64, 1e-12)):
        rop = dataclasses.replace(op, wt=torch.randn(
            op.wt.shape, generator=gen, dtype=torch.float32).to("cuda", dt))
        out[name] = _patch_held(rop, torch.randn(
            op.n_rows, generator=gen, dtype=torch.float64).to("cuda", dt),
            rtol)
        del rop
    # block: the elasticity operator, one stencil launch for both row
    # variables, the column variables looped inside the kernel
    a = esys.assemblers[-1]
    u0 = torch.zeros(a.n_dofs, dtype=torch.float32, device="cuda")
    _, data = a.make_assemble_fn(pass_tables=True)(
        u0, a.device_tables_cached())
    bop = a.op_with(data)
    x = torch.randn(bop.n_rows, generator=gen, dtype=torch.float32).cuda()
    brow = _patch_held(bop, x, 1e-5)
    brt = bop.routing
    btables = sum(t.numel() for t in (brt.face_code, brt.corner_vert,
                                      brt.edge_sides, brt.vert_sides))
    bbytes, _ = patch_kernel_work(bop.meta[0], bop.meta[1], isz, bop.meta[6],
                                  btables, nv=bop.nv)
    brow.update({"H": bop.meta[0], "P": bop.meta[1], "n": bop.n_rows,
                 "nv": bop.nv, "block_matvec_ms": time_cold_ms(
                     lambda: bop.matvec(x)),
                 "back_to_back_ms": time_ms(lambda: bop.matvec(x)),
                 "bytes": bbytes,
                 "bound_ms": bbytes / HBM_BYTES_PER_S * 1e3,
                 **_matvec_launches(bop, x)})
    out["elasticity_block"] = brow
    rop = dataclasses.replace(bop, wt=torch.randn(
        bop.wt.shape, generator=gen, dtype=torch.float32).cuda())
    out["elasticity_block_random_f32"] = _patch_held(rop, x, 1e-5)
    del rop
    emit({"phase": "patch_kernel", **out})
    if not all(r["ok"] and r["repeats_bit_for_bit"] for r in out.values()):
        raise AssertionError("patch kernel disagrees with its plain version")
    for r in (out["poisson"], out["elasticity_block"]):
        if (r["launches_per_matvec"] > 2.2 or r["other_kernels"]
                or r["matmul_kernels"]):
            raise AssertionError("a patch matvec took more than two "
                                 f"launches or a matrix product: {r}")
    return out["poisson"]


def phase_patch_solve(sys_, ml_mesh, ml_sol, names, label: str,
                      setup_s: float) -> dict:
    """LinearImplicitSystem.solve on a patch configuration, with the
    launch counts set to 0 just before it and read just after."""
    from femus_tpu_torch.systems.system import launch_counts

    reset_launches()
    t0 = time.perf_counter()
    info = sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # a second solve step from the same initial state, after warm-up
    u_init = torch.as_tensor(sys_.gather(-1) * 0.0, dtype=sys_.dtype,
                             device="cuda")
    t0 = time.perf_counter()
    again = sys_.step_fn(-1)(u_init)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    fields_ok = all(np.all(np.isfinite(ml_sol.sol[-1][n])) for n in names)
    rep = {"phase": label, "setup_s": setup_s, "solve_wall_s": wall,
           "second_step_s": steady, "second_step_iters": again.lin_iters,
           "gmres_iters": info["iters"], "residual": info["residual"],
           "target": info["target"],
           "residual_over_target": info["residual"] / info["target"],
           "converged": info["converged"], "kernel_launches": launches,
           "n_dofs": [a.n_dofs for a in sys_.assemblers],
           "tensors_on_cuda": _all_on_cuda(sys_), "fields_finite": fields_ok,
           "routing": sys_.solver_info()["routing"]}
    if names == ["u"]:
        xy = ml_mesh.levels[-1].node_coords_of("biquadratic")
        exact = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
        rep["max_nodal_err"] = float(np.abs(ml_sol.sol[-1]["u"] - exact).max())
    else:
        rep["max_abs_disp"] = float(max(np.abs(ml_sol.sol[-1][n]).max()
                                        for n in names))
    emit(rep)
    if not (info["converged"] and info["iters"] < 20):
        raise AssertionError(f"{label}: the MG-GMRES drive failed ({info})")
    if not info["residual"] <= RESIDUAL_SLACK[label] * info["target"]:
        raise AssertionError(f"{label}: true residual {info['residual']} "
                             f"above {RESIDUAL_SLACK[label]} x target "
                             f"{info['target']}")
    if launches["patch_stencil"] <= 0:
        raise AssertionError(f"{label}: the solve launched no patch kernel")
    if rep.get("max_nodal_err", 0.0) >= PATCH_ERR_MAX:
        raise AssertionError(f"{label}: nodal error {rep['max_nodal_err']}")
    if not (rep["tensors_on_cuda"] and fields_ok):
        raise AssertionError(f"{label}: tensors off the card or non-finite "
                             "fields")
    return rep


def phase_patch_reference() -> None:
    """Both patch problems at a small size: the card's float32 solve
    against the host's float64 solve."""
    rep = {"phase": "patch_reference"}
    for problem in ("poisson", "elasticity"):
        fields = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            sys_, _, ml_sol, names = patch_system(problem, 4, 3, device,
                                                  dtype, rtol=1e-6)
            sys_.solve()
            fields[device] = np.concatenate([ml_sol.sol[-1][n]
                                             for n in names])
        ref = fields["cpu"]
        rep[problem] = float(np.linalg.norm(fields["cuda"] - ref)
                             / np.linalg.norm(ref))
        rep[problem + "_n_dofs"] = int(ref.size)
    emit(rep)
    if not max(rep["poisson"], rep["elasticity"]) < 1e-4:
        raise AssertionError(f"card and host patch solutions differ: {rep}")


def lattice_operators(n: int, device, dtype) -> dict:
    """The lattice operator of an n x n Q2 Poisson box by both routes:
    generic assembly -> ELL (A) -> DIA (D) -> stencil (S), and the
    scatter-free lattice assembly (R2, S2), with the seconds of each route
    (the lattice route reuses the assembler's device tables)."""
    from femus_tpu_torch.algebra.dia import build_dia_plan
    from femus_tpu_torch.algebra.stencil import build_stencil
    from femus_tpu_torch.assembly.bc import generate_bdc
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.assembly.lattice import (build_lattice_plan,
                                                  make_lattice_assemble_fn)
    from femus_tpu_torch.mesh.generation import unit_box

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    pi = np.pi
    t0 = time.perf_counter()
    asm = Assembler(unit_box((n, n), "quad"), [Unknown("u", "biquadratic")],
                    quad_order="fifth", dtype=dtype, device=device)
    asm.set_volume_form(poisson(
        "u", "biquadratic", rhs=lambda x: 2 * pi ** 2
        * torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])))
    generate_bdc(asm, lambda var, x, grp, t: (True, 0.0))
    tables = asm.device_tables_cached()
    u0 = torch.zeros(asm.n_dofs, dtype=dtype, device=device)
    R, data = asm.make_assemble_fn(pass_tables=True)(u0, tables)
    A = asm.op_with(data, tables["ell_cols"])
    plan = build_dia_plan(asm.pattern, max_diags=64)
    D = plan.apply(data, asm.pattern.n_rows)
    S = build_stencil(D, row_width=2 * n + 1)
    sync()
    t_generic = time.perf_counter() - t0
    t0 = time.perf_counter()
    lplan = build_lattice_plan(asm)
    R2, S2 = make_lattice_assemble_fn(asm, lplan)(u0, tables)
    sync()
    t_lattice = time.perf_counter() - t0
    return {"asm": asm, "A": A, "D": D, "S": S, "R": R, "R2": R2, "S2": S2,
            "ell_data": data, "generic_s": t_generic,
            "lattice_s": t_lattice}


def phase_lattice_setup() -> dict:
    ops = lattice_operators(LATTICE_N, "cuda", torch.float32)
    S, S2 = ops["S"], ops["S2"]
    # the two routes order their offsets differently: compare slab by slab
    order = [S2.offsets.index(o) for o in S.offsets]
    scale = float(S.data.abs().max())
    s_err = float((S2.data[order] - S.data).abs().max())
    r_scale = float(ops["R"].abs().max())
    r_err = float((ops["R2"] - ops["R"]).abs().max())
    halo = max(max(abs(di), abs(dj)) for di, dj in S.offsets)
    # both routes sum the same element entries in float32, the generic one
    # with atomics in a varying order: a few ulps of the largest entry
    tol = 1e-5
    emit({"phase": "lattice_setup", "n_dofs": S.n_rows, "grid": S.grid,
          "nnz": int(ops["asm"].pattern.nnz), "offsets": len(S.offsets),
          "halo": halo, "generic_s": ops["generic_s"],
          "lattice_s": ops["lattice_s"], "stencil_max_abs_diff": s_err,
          "stencil_scale": scale, "residual_max_abs_diff": r_err,
          "residual_scale": r_scale, "rtol": tol})
    if len(S.offsets) != 25 or halo > 2 or set(S2.offsets) != set(S.offsets):
        raise AssertionError(f"lattice offsets {S.offsets}")
    if not (s_err <= tol * scale and r_err <= tol * r_scale):
        raise AssertionError("lattice assembly disagrees with the generic "
                             f"route: {s_err}/{scale}, {r_err}/{r_scale}")
    return ops


def lattice_kernel_work(offsets, shape, isz: int) -> tuple:
    """(bytes, flops) kernel B4 (``offsets``: ints, ``shape`` = (n,)) or B3
    (``offsets``: (di, dj) pairs, ``shape`` = (N, M)) must move and do:
    every weight whose x index lies inside the vector or lattice (a term
    outside multiplies zero and is not read), read once; x read once and y
    written once."""
    if len(shape) == 1:
        n = shape[0]
        weights = sum(max(n - abs(o), 0) for o in offsets)
    else:
        N, M = shape
        n = N * M
        weights = sum(max(N - abs(di), 0) * max(M - abs(dj), 0)
                      for di, dj in offsets)
    return (weights + 2 * n) * isz, 2 * weights


def _held(y_k, y_p, y_abs, rtol) -> dict:
    err = float((y_k - y_p).abs().max())
    scale = float(y_abs.max())
    return {"max_abs_err": err, "scale": scale, "rtol": rtol,
            "ok": err <= rtol * scale}


def phase_lattice_kernel(ops, patch_row) -> dict:
    """B4 and B3 against their plain versions on the lattice operator and
    on random-data operators; times and bounds on the lattice operator."""
    from femus_tpu_torch.algebra import dia, stencil

    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, dtype=torch.float64
                           ).to(dtype).cuda()

    A, D, S = ops["A"], ops["D"], ops["S"]
    n = D.n
    x = rand(n)
    out = {"n": n, "nnz": int(ops["asm"].pattern.nnz),
           "K": len(D.offsets), "grid": S.grid}
    checks = {}
    # the kernel fuses multiply-adds and skips out-of-range terms, the plain
    # version does neither: a float32 / float64 rounding budget of
    # max(|A| |x|), as for B1 and B2
    y4 = dia.spmv_dia_cuda(D, x)
    y3 = stencil.spmv_stencil_cuda(S, x)
    torch.cuda.synchronize()
    checks["dia_assembled_f32"] = _held(
        y4, dia._matvec_plain(D.data, D.offsets, x),
        dia._matvec_plain(D.data.abs(), D.offsets, x.abs()), 1e-5)
    checks["stencil_assembled_f32"] = _held(
        y3, stencil._matvec_plain(S.data, S.offsets, S.grid, x),
        stencil._matvec_plain(S.data.abs(), S.offsets, S.grid, x.abs()),
        1e-5)
    checks["stencil_vs_dia_vs_ell"] = {
        "max_abs_diff": float(max((y3 - y4).abs().max(),
                                  (y3 - A @ x).abs().max())),
        "scale": checks["dia_assembled_f32"]["scale"], "rtol": 1e-5}
    checks["stencil_vs_dia_vs_ell"]["ok"] = (
        checks["stencil_vs_dia_vs_ell"]["max_abs_diff"]
        <= 1e-5 * checks["stencil_vs_dia_vs_ell"]["scale"])
    # random data: the flattened form wraps across lattice rows, the 2-D
    # form reads zero there; each against its own plain version
    nr, offs_r = 2 ** 20 + 3, (-1025, -1, 0, 1, 1025)
    grid_r = (1023, 1029)
    soffs_r = ((-8, -8), (-8, 8), (-3, 0), (0, -8), (0, 0), (0, 1), (2, -5),
               (8, -8), (8, 8))
    for name, dt, rtol in (("f32", torch.float32, 1e-5),
                           ("f64", torch.float64, 1e-12)):
        Dr = dia.DiaOp(rand(len(offs_r), nr, dtype=dt), offs_r, nr)
        xr = rand(nr, dtype=dt)
        yk = dia.spmv_dia_cuda(Dr, xr)
        torch.cuda.synchronize()
        checks["dia_random_" + name] = _held(
            yk, dia._matvec_plain(Dr.data, offs_r, xr),
            dia._matvec_plain(Dr.data.abs(), offs_r, xr.abs()), rtol)
        Sr = stencil.StencilOp(rand(len(soffs_r), *grid_r, dtype=dt),
                               soffs_r, grid_r)
        xr = rand(Sr.n_rows, dtype=dt)
        yk = stencil.spmv_stencil_cuda(Sr, xr)
        torch.cuda.synchronize()
        checks["stencil_random_" + name] = _held(
            yk, stencil._matvec_plain(Sr.data, soffs_r, grid_r, xr),
            stencil._matvec_plain(Sr.data.abs(), soffs_r, grid_r, xr.abs()),
            rtol)
        del Dr, Sr, xr, yk
    out["checks"] = checks
    # library yardstick: one torch.sparse CSR matvec of the same matrix
    pat = ops["asm"].pattern
    valid = torch.as_tensor(pat.valid, device="cuda")
    cols = torch.as_tensor(pat.cols, dtype=torch.int64, device="cuda")
    counts = valid.sum(dim=1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    csr = torch.sparse_csr_tensor(crow, cols[valid], ops["ell_data"][valid],
                                  check_invariants=False, size=(n, n))
    library_err = float((csr @ x - y3).abs().max())
    isz = D.data.element_size()
    nnz_bytes = out["nnz"] * isz + 2 * n * isz
    kernels = {}
    # timed in turns (kernel, plain, kernel) so both kernels see the same
    # card state; the second kernel timing is the one reported.  Cold times
    # (see time_cold_ms): a back-to-back timing of these 0.04 ms calls reads
    # the host's enqueue rate on a slow host
    for name, kern, plain, work in (
            ("dia_spmv", lambda: dia.spmv_dia_cuda(D, x),
             lambda: dia._matvec_plain(D.data, D.offsets, x),
             lattice_kernel_work(D.offsets, (n,), isz)),
            ("stencil_spmv", lambda: stencil.spmv_stencil_cuda(S, x),
             lambda: stencil._matvec_plain(S.data, S.offsets, S.grid, x),
             lattice_kernel_work(S.offsets, S.grid, isz))):
        first_ms = time_cold_ms(kern)
        plain_ms = time_ms(plain, reps=20)
        ms = time_cold_ms(kern)
        t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
        t_ops = work[1] / F32_FLOPS_PER_S * 1e3
        kernels[name] = {
            "ms": ms, "first_ms": first_ms, "plain_ms": plain_ms,
            "back_to_back_ms": time_ms(kern),
            "bytes": work[0], "slab_bytes": D.data.numel() * isz,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "pct_of_bound": 100.0 * max(t_bytes, t_ops) / ms,
            "bound_nnz_ms": nnz_bytes / HBM_BYTES_PER_S * 1e3}
    kernels["dia_spmv"]["max_abs_err"] = \
        checks["dia_assembled_f32"]["max_abs_err"]
    kernels["stencil_spmv"]["max_abs_err"] = \
        checks["stencil_assembled_f32"]["max_abs_err"]
    out.update(kernels)
    out["ell_matvec_ms"] = time_ms(lambda: A @ x, reps=20)
    out["library_ms"] = time_cold_ms(lambda: csr @ x)
    out["library_back_to_back_ms"] = time_ms(lambda: csr @ x)
    out["library_err"] = library_err
    # the same matrix through the patch format (phase patch_kernel)
    out["same_matrix"] = {"patch_stencil_ms": patch_row["ms"],
                          "patch_matvec_ms": patch_row["matvec_ms"],
                          "patch_phase_library_ms": patch_row["library_ms"]}
    emit({"phase": "lattice_kernel", **out})
    bad = [k for k, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"lattice kernels disagree: {bad}")
    for name in ("dia_spmv", "stencil_spmv"):
        kernels[name]["library_ms"] = out["library_ms"]
    return kernels


def power_sweep(matvec, n: int, dtype, device, steps: int, x=None):
    """``steps`` of x <- w / max|w|, w = A x, from x = 1: (x, last max|w|,
    device ms of the whole sweep by CUDA events, None on the host)."""
    x = torch.ones(n, dtype=dtype, device=device) if x is None else x
    on_card = x.is_cuda
    if on_card:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
    top = None
    for _ in range(steps):
        w = matvec(x)
        top = w.abs().max()
        x = w / top
    if on_card:
        e1.record()
        e1.synchronize()
    return x, float(top), (e0.elapsed_time(e1) if on_card else None)


def lattice_cg(ops, maxiter: int = 2000):
    """-Lap u = 2 pi^2 sin(pi x) sin(pi y) on the lattice operator with the
    package's own pieces: CG on StencilOp.matvec, preconditioned by one
    degree-3 Chebyshev sweep from a zero guess (diagonal from
    DiaOp.diagonal(), lambda_max by power iteration), rhs -R of the lattice
    assembly at u = 0.  Returns (u, SolveInfo, max nodal error)."""
    from femus_tpu_torch.algebra.krylov import cg
    from femus_tpu_torch.algebra.smoothers import (chebyshev_smoother,
                                                   power_lambda_max)

    S, diag = ops["S2"], ops["D"].diagonal()
    lam = power_lambda_max(S.matvec, 1.0 / diag, S.n_rows)
    smooth = chebyshev_smoother(S.matvec, diag, lam, degree=3)
    u, info = cg(S.matvec, -ops["R2"],
                 M=lambda r: smooth(r, torch.zeros_like(r)), tol=1e-4,
                 maxiter=maxiter)
    asm = ops["asm"]
    xy = asm.mesh.coords[asm.dofmaps["u"].nodes]
    exact = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
    return u, info, float(np.abs(u.double().cpu().numpy() - exact).max())


def phase_lattice_main(ops) -> dict:
    from femus_tpu_torch.systems.system import launch_counts

    n, nnz = ops["D"].n, int(ops["asm"].pattern.nnz)
    rep = {"phase": "lattice_main", "n_dofs": n, "nnz": nnz}
    # (a) the normalised power sweep through each format
    reset_launches()
    sweeps = {}
    for name, op in (("stencil_spmv", ops["S"]), ("dia_spmv", ops["D"]),
                     ("ell", ops["A"])):
        x10, _, _ = power_sweep(op.matvec, n, torch.float32, "cuda",
                                SWEEP_WARM)
        x, top, ms = power_sweep(op.matvec, n, torch.float32, "cuda",
                                 SWEEP_STEPS, x=x10)
        sweeps[name] = (x10, top)
        rep["sweep_" + name] = {"ms_per_step": ms / SWEEP_STEPS,
                                "nnz_per_s": nnz * SWEEP_STEPS / (ms * 1e-3),
                                "eig_estimate": top,
                                "finite": bool(torch.isfinite(x).all())}
    rep["sweep_launches"] = launch_counts()
    ref10, ref_top = sweeps["ell"]
    rep["sweep_x10_max_diff"] = max(
        float((sweeps[k][0] - ref10).abs().max())
        for k in ("stencil_spmv", "dia_spmv"))
    rep["sweep_eig_rel_diff"] = max(
        abs(sweeps[k][1] - ref_top) / abs(ref_top)
        for k in ("stencil_spmv", "dia_spmv"))
    # (b) the Chebyshev-CG solve on the stencil operator
    reset_launches()
    t0 = time.perf_counter()
    u, info, err = lattice_cg(ops)
    torch.cuda.synchronize()
    rep.update({"cg_wall_s": time.perf_counter() - t0, "cg_iters": info.iters,
                "cg_residual": info.residual, "cg_target": info.target,
                "cg_converged": info.converged, "max_nodal_err": err,
                "cg_launches": launch_counts(),
                "fields_finite": bool(torch.isfinite(u).all())})
    emit(rep)
    if not all(rep["sweep_" + k]["finite"] for k in sweeps):
        raise AssertionError("lattice_main: a sweep left the finite range")
    # x is normalised to max|x| = 1, so an absolute difference is relative
    if not (rep["sweep_x10_max_diff"] <= 1e-5
            and rep["sweep_eig_rel_diff"] <= 1e-3):
        raise AssertionError("lattice_main: the formats' sweeps disagree")
    if rep["sweep_launches"]["dia_spmv"] != SWEEP_WARM + SWEEP_STEPS:
        raise AssertionError("lattice_main: the DIA sweep did not run B4")
    if not (info.converged and rep["fields_finite"]):
        raise AssertionError(f"lattice_main: CG failed ({info})")
    if err >= PATCH_ERR_MAX:
        raise AssertionError(f"lattice_main: nodal error {err}")
    if rep["cg_launches"]["stencil_spmv"] <= 0:
        raise AssertionError("lattice_main: the solve launched no B3")
    return rep


def phase_lattice_reference() -> None:
    """Set-up, sweep and CG solve at n=16: the card's float32 against the
    host's float64."""
    got = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        ops = lattice_operators(16, device, dtype)
        n = ops["D"].n
        sw = {k: power_sweep(ops[k].matvec, n, dtype, device, SWEEP_WARM)
              for k in ("S", "D", "A")}
        u, info, err = lattice_cg(ops)
        got[device] = {
            "S": ops["S"].data.double().cpu().numpy(),
            "S2": ops["S2"].data.double().cpu().numpy(),
            "R2": ops["R2"].double().cpu().numpy(),
            "sweep": np.stack([v[0].double().cpu().numpy()
                               for v in sw.values()]),
            "eig": np.array([v[1] for v in sw.values()]),
            "u": u.double().cpu().numpy(), "iters": info.iters, "err": err,
            "converged": info.converged}
    rep = {"phase": "lattice_reference", "n_dofs": int(got["cpu"]["u"].size),
           "cg_iters": {d: got[d]["iters"] for d in got},
           "max_nodal_err": {d: got[d]["err"] for d in got}}
    for key in ("S", "S2", "R2", "sweep", "eig", "u"):
        ref = got["cpu"][key]
        rep[key] = float(np.linalg.norm(got["cuda"][key] - ref)
                         / np.linalg.norm(ref))
    emit(rep)
    worst = max(rep[k] for k in ("S", "S2", "R2", "sweep", "eig", "u"))
    if not (worst < 1e-4 and got["cuda"]["converged"]
            and got["cpu"]["converged"]):
        raise AssertionError(f"card and host lattice paths differ: {rep}")


# Newton steps of each cycles_reference route (a cut in depth for the
# run's clock: the routes agree to their linear tolerance at every Newton
# step)
CYCLES_NEWTON = 2


def phase_cycles_reference() -> None:
    """The small cavity on the card through the solver routes beside the
    V-cycle: each must converge and agree with the V-cycle solve.  The
    routes: mg_cycle W, F, K (FGMRES); operator="matrix_free"; stacked
    dofs with rediscretized coarse levels (Vanka on each level's own
    pattern, B1 on the two finer levels), and that hierarchy built with
    compute_dtype=bfloat16; the matrix-free hierarchy built with
    compute_dtype=bfloat16; the V-cycle built with bfloat16
    (``bf16_newton``).  Routes that differ only in the cycle or in the
    compute type share one System, reset to its initial state.  Then a
    Neumann problem through a face form: operator="matrix_free" against
    "assembled"."""
    from femus_tpu_torch.systems.system import launch_counts

    stacked = {"interleave_dofs": False}
    routes = {"V": {}, "W": {"mg_cycle": "W"}, "F": {"mg_cycle": "F"},
              "K": {"mg_cycle": "K"},
              "matrix_free": {"operator": "matrix_free", **stacked},
              "rediscretize": {"coarse_op": "rediscretize", **stacked},
              "rediscretize_bf16": {"coarse_op": "rediscretize", **stacked},
              "matrix_free_bf16": {"operator": "matrix_free", **stacked}}
    bf16_builder = {"rediscretize_bf16": "build_hierarchy_from_ops",
                    "matrix_free_bf16": "build_hierarchy_matfree"}
    built = {}

    def system_for(config):
        """The cavity of ``config``, built once per set-up and reset to
        its initial state, its steps to be built anew."""
        setup = {k: v for k, v in config.items() if k != "mg_cycle"}
        key = tuple(sorted(setup.items()))
        if key not in built:
            s, m = cavity_system(8, 3, "cuda", torch.float32, rtol=1e-6,
                                 max_nonlinear=CYCLES_NEWTON, **setup)
            built[key] = (s, m, s.snapshot())
        s, m, start = built[key]
        s.config.mg_cycle = config.get("mg_cycle", "V")
        s.reset(start)
        return s, m

    rep = {"phase": "cycles_reference"}
    ref = None
    for name, config in routes.items():
        sys_, ml_sol = system_for(config)
        n0 = launch_counts()["bell_spmv"]
        with (cycle_dtype(bf16_builder[name], torch.bfloat16)
              if name in bf16_builder else contextlib.nullcontext()):
            sys_.solve()
        fields = np.concatenate([ml_sol.sol[-1][n] for n in ("u", "v", "p")])
        ref = fields if ref is None else ref
        rep[name] = {
            "gmres_iters": [h["lin_iters"] for h in sys_.history],
            "converged": all(h["converged"] for h in sys_.history),
            "rel_diff": float(np.linalg.norm(fields - ref)
                              / np.linalg.norm(ref)),
            "outer": ("fgmres" if name == "K" else "gmres"),
            "b1_launches": launch_counts()["bell_spmv"] - n0}
        if name.startswith("rediscretize"):
            rep[name]["bell_levels"] = sorted(_bell_rows(sys_))
    # the bf16 route: the V-cycle built with compute_dtype=bfloat16
    sys_, ml_sol = system_for({})
    n0 = launch_counts()["bell_spmv"]
    hist = bf16_newton(sys_)
    fields = np.concatenate([ml_sol.sol[-1][n] for n in ("u", "v", "p")])
    rep["bf16"] = {"gmres_iters": [h["lin_iters"] for h in hist],
                   "converged": all(h["converged"] for h in hist),
                   "rel_diff": float(np.linalg.norm(fields - ref)
                                     / np.linalg.norm(ref)),
                   "outer": "gmres", "coarse_lu": "float32",
                   "b1_launches": launch_counts()["bell_spmv"] - n0}
    # a face form through the matrix-free operator
    faces = {op: neumann_solve(op) for op in ("matrix_free", "assembled")}
    u_mf, u_as = faces["matrix_free"][0], faces["assembled"][0]
    rep["matrix_free_faces"] = {
        "converged": all(f[1]["converged"] for f in faces.values()),
        "gmres_iters": {op: f[1]["iters"] for op, f in faces.items()},
        "rel_diff": float(np.linalg.norm(u_mf - u_as)
                          / np.linalg.norm(u_as)),
        "max_err_vs_exact": faces["matrix_free"][2]}
    rep["n_dofs"] = int(ref.size)
    emit(rep)
    for name in list(routes) + ["bf16", "matrix_free_faces"]:
        if not (rep[name]["converged"] and rep[name]["rel_diff"] < 1e-3):
            raise AssertionError(f"cycles_reference: route {name} failed: "
                                 f"{rep[name]}")
    for name in ("bf16", "rediscretize", "rediscretize_bf16"):
        if rep[name]["b1_launches"] <= 0:
            raise AssertionError(f"cycles_reference: the {name} route ran "
                                 "no B1")
    for name in ("rediscretize", "rediscretize_bf16"):
        if rep[name]["bell_levels"] != [2946, 11522]:
            raise AssertionError(f"cycles_reference: {name} routing "
                                 f"{rep[name]['bell_levels']}")


def neumann_solve(operator: str, coarse: int = 8, levels: int = 3,
                  device="cuda", dtype=torch.float32):
    """tests/test_poisson.py's Neumann problem as a system (on the card in
    float32 by default): -Lap u = -4 on unit_box((coarse, coarse)) refined to
    ``levels`` levels, u = x^2 + y^2 on three sides, du/dn = 2 on x = 1
    through the face form; (u, solve info, max nodal error)."""
    from femus_tpu_torch.assembly.forms import neumann_faces, poisson
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (
        (False, 0.0) if grp == 2 else (True, float(x[0] ** 2 + x[1] ** 2))))
    ml_sol.generate_bdc("u")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(LinearImplicitSystem, "P")
    sys_.add_unknown("u")
    sys_.set_assembly(poisson("u", rhs=lambda x: -4.0 + 0.0 * x[:, 0]),
                      neumann_faces({2: lambda x, nrm: 2.0 + 0.0 * x[:, 0]},
                                    "u"))
    sys_.config.operator = operator
    sys_.config.rtol = 1e-6
    sys_.init(device=device, dtype=dtype)
    info = sys_.solve()
    u = ml_sol.sol[-1]["u"].copy()
    xy = ml_mesh.levels[-1].node_coords_of("biquadratic")
    return u, info, float(np.abs(u - (xy ** 2).sum(axis=1)).max())


def bf16_newton(sys_) -> list:
    """Newton steps of a cavity system whose V-cycle is built with
    ``build_hierarchy(..., compute_dtype=torch.bfloat16)``: operators and
    transfers stored in bfloat16, every level of at least 2048 rows on its
    BELL-frame plan (B1 multiplies bfloat16 values into float32 vectors),
    the coarse LU in float32; the system's own outer GMRES around it."""
    from femus_tpu_torch.algebra.bell import bell_backed
    from femus_tpu_torch.algebra.mg import build_hierarchy
    from femus_tpu_torch.algebra.vanka import build_element_blocks

    cfg = sys_.config
    lv = len(sys_.assemblers) - 1
    a = sys_.assemblers[lv]
    tr = sys_._transfers_for(lv)
    pats = [t[2].coarse_pattern for t in tr] + [a.pattern]
    # level 0 is LU-solved: no plan, no Vanka blocks (as System.step_fn)
    plans = [None] + [sys_._bell_dev(p) for p in pats[1:]]
    vblocks = [None] + [build_element_blocks(
        sys_.assemblers[j], cfg.vanka_block_elems,
        pattern=pats[j] if j < lv else None, device=sys_.device)
        for j in range(1, lv + 1)]
    dmasks = [torch.as_tensor(m, device=sys_.device)
              for m in sys_.masks[:lv]]
    assemble = a.make_assemble_fn(pass_tables=True)
    hist = []
    for it in range(cfg.max_nonlinear):
        u = torch.as_tensor(sys_.gather(lv), dtype=sys_.dtype,
                            device=sys_.device)
        tables = a.device_tables_cached()
        R, data = assemble(u, tables, sys_.aux_scalars)
        A = bell_backed(plans[-1], a.op_with(data, tables["ell_cols"]))
        h = build_hierarchy(A, tr, smoother=cfg.smoother, n_pre=cfg.n_pre,
                            n_post=cfg.n_post, dir_masks=dmasks,
                            vanka_blocks=vblocks,
                            vanka_omega=cfg.vanka_omega,
                            vanka_multiplicative=cfg.vanka_multiplicative,
                            compute_dtype=torch.bfloat16,
                            coarse_dense_max=cfg.coarse_dense_max_dofs,
                            bell_plans=plans, device=sys_.device)
        if h.coarse_lu[0].dtype != torch.float32:
            raise AssertionError("bf16 route: the coarse LU is not float32")
        delta, info = sys_._outer_solve(A.matvec, -R,
                                        h.as_preconditioner("V"))
        u_new = (u + delta).cpu().numpy()
        norms = sys_.eps_norms(delta.cpu().numpy(), u_new, lv)
        sys_.scatter(u_new, lv)
        hist.append({"lin_iters": info.iters, "converged": info.converged,
                     "eps": norms})
        if max(norms.values()) < cfg.nonlinear_tol:
            break
    return hist


def oc_system(kind: str, coarse: int, levels: int, device, dtype,
              rtol: float, max_nonlinear: int = OC_NEWTON):
    """An optimal-control KKT system through the port's public entry
    points: y, l, u biquadratic on MultiLevelMesh(unit_box((coarse,
    coarse)), levels), y_d = sin(pi x) sin(pi y).  kind:
    "distributed" — elliptic_control_form (alpha OC_ALPHA), y and l
        Dirichlet, as a PDASControlSystem;
    "boundary" — boundary_control_forms (alpha OC_BOUNDARY_ALPHA, Neumann
        control on group OC_CTRL_GROUP, the x = 1 face), y and l Neumann
        there, fix_interior_control;
    "theta" — ScalarConstrainedSystem with the zero-mean control
        constraint of tests/test_theta_constraint.py (alpha 1e-2, target
        sin(pi x) sin(pi y) + x y), operator="assembled".
    Solver: RCM hierarchy, stacked dofs (interleave_dofs=False), Vanka
    V-cycle (2 elements per block, multiplicative), GMRES(60) with
    OC_MAX_OUTER restarts, operator="bell" (distributed, boundary)."""
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy
    from femus_tpu_torch.systems import optimal_control as oc
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import NonLinearImplicitSystem

    pi = np.pi

    def y_d(x):
        yd = torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])
        return yd + x[:, 0] * x[:, 1] if kind == "theta" else yd

    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    rcm_reorder_hierarchy(ml_mesh)
    ml_sol = MultiLevelSolution(ml_mesh)
    for v in ("y", "l", "u"):
        ml_sol.add_solution(v, "biquadratic")
        ml_sol.initialize(v)
    if kind == "boundary":
        ml_sol.attach_bc(lambda var, x, grp, t: (
            (grp != OC_CTRL_GROUP) if var in ("y", "l") else False, 0.0))
    else:
        ml_sol.attach_bc(lambda var, x, grp, t: (var in ("y", "l"), 0.0))
    ml_sol.generate_bdc("y", "l", "u")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    cls = {"distributed": oc.PDASControlSystem,
           "boundary": NonLinearImplicitSystem,
           "theta": oc.ScalarConstrainedSystem}[kind]
    sys_ = prob.add_system(cls, "OC-" + kind)
    sys_.add_unknown("y", "l", "u")
    if kind == "boundary":
        sys_.set_assembly(*oc.boundary_control_forms(
            y_target=y_d, alpha=OC_BOUNDARY_ALPHA,
            control_groups=(OC_CTRL_GROUP,)))
    else:
        sys_.set_assembly(oc.elliptic_control_form(
            "y", "l", "u", y_target=y_d,
            alpha=1e-2 if kind == "theta" else OC_ALPHA))
    cfg = sys_.config
    cfg.operator = "assembled" if kind == "theta" else "bell"
    cfg.interleave_dofs = False
    cfg.smoother = "vanka"
    cfg.vanka_block_elems = 2
    cfg.vanka_multiplicative = True
    cfg.mg_type = "V"
    cfg.restart = 60
    cfg.max_outer = OC_MAX_OUTER
    cfg.rtol = rtol
    cfg.max_nonlinear = max_nonlinear
    sys_.init(device=device, dtype=dtype)
    if kind == "boundary":
        oc.fix_interior_control(sys_, "u", (OC_CTRL_GROUP,))
    elif kind == "theta":
        sys_.add_scalar_constraint("theta", oc.assemble_constraint_vector(
            sys_, volume_form=lambda ops, u, aux: {"u": ops.t(
                "biquadratic", ops.pointwise(lambda x: 1.0 + 0.0 * x[:, 0]))
            }), rhs=0.0)
    return sys_, ml_sol


def _solves_ok(sys_) -> bool:
    return all(h["converged"] for h in sys_.history)


def phase_oc_setup() -> tuple:
    t0 = time.perf_counter()
    sys_, ml_sol = oc_system("distributed", OC_COARSE, OC_LEVELS, "cuda",
                             OC_DTYPE, OC_RTOL)
    setup_s = time.perf_counter() - t0
    a = sys_.assemblers[-1]
    sys_._bell_dev(a.pattern)                 # the fine plan's routing note
    emit({"phase": "oc_setup", "config": "oc-distributed-128",
          "seconds": setup_s, "n_dofs": [b.n_dofs for b in sys_.assemblers],
          "nnz": int(a.pattern.nnz),
          "row_max": int(a.pattern.valid.sum(axis=1).max()),
          "coarse_nnz": [int(t[2].coarse_pattern.nnz)
                         for t in sys_.transfers],
          "dtype": str(OC_DTYPE), "routing": sys_.solver_info()["routing"]})
    return sys_, ml_sol, setup_s


def phase_oc_main(sys_, ml_sol) -> dict:
    """The unconstrained KKT solve (NonLinearImplicitSystem.solve of the
    PDAS system, before any bound), with the launch counts set to 0 just
    before it and read just after."""
    from femus_tpu_torch.systems.optimal_control import cost_functional
    from femus_tpu_torch.systems.system import launch_counts

    reset_launches()
    _flush_buffer.clear()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    sol = ml_sol.sol[-1]
    pi = np.pi
    t0 = time.perf_counter()
    J = cost_functional(sys_.ml_mesh.finest(), "biquadratic", sol["y"],
                        sol["u"], lambda x: torch.sin(pi * x[:, 0])
                        * torch.sin(pi * x[:, 1]), OC_ALPHA, device="cuda")
    j_s = time.perf_counter() - t0
    l_inf = float(np.abs(sol["l"]).max())
    grad_err = float(np.abs(OC_ALPHA * sol["u"] - sol["l"]).max())
    finite = all(np.all(np.isfinite(sol[v])) for v in ("y", "l", "u"))
    rep = {"phase": "oc_main", "wall_s": wall,
           "newton_steps": len(sys_.history),
           "gmres_iters": [h["lin_iters"] for h in sys_.history],
           "step_seconds": [h["seconds"] for h in sys_.history],
           "lin_res": [h["lin_res"] for h in sys_.history],
           "lin_target": [h["lin_target"] for h in sys_.history],
           "linear_solves_converged": _solves_ok(sys_),
           "J": J, "cost_functional_s": j_s, "grad_eq_err": grad_err,
           "l_inf": l_inf, "u_range": [float(sol["u"].min()),
                                       float(sol["u"].max())],
           "kernel_launches": launches, "fields_finite": finite,
           "tensors_on_cuda": _all_on_cuda(sys_)}
    emit(rep)
    if not rep["linear_solves_converged"]:
        raise AssertionError("oc_main: a linear solve missed its rtol")
    if not grad_err <= 1e-6 * max(1.0, l_inf):
        raise AssertionError(f"oc_main: |alpha u - l| = {grad_err:.3g}")
    if not (np.isfinite(J) and finite and rep["tensors_on_cuda"]):
        raise AssertionError("oc_main: non-finite J or fields, or tensors "
                             "off the card")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("oc_main: the solve launched no B1")
    return rep


def phase_oc_pdas(sys_, ml_sol) -> dict:
    """solve_pdas from the unconstrained optimum, bounds OC_BOUNDS."""
    from femus_tpu_torch.systems.system import launch_counts

    sys_.set_control_bounds("u", *OC_BOUNDS, alpha=OC_ALPHA)
    reset_launches()
    t0 = time.perf_counter()
    info = sys_.solve_pdas(max_iters=OC_PDAS_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    u = ml_sol.sol[-1]["u"]
    lo, hi = OC_BOUNDS
    rep = {"phase": "oc_pdas", "wall_s": wall, "bounds": OC_BOUNDS,
           "pdas_iters": info["pdas_iters"],
           "iterations": sys_.pdas_history,
           "active_hi": info["active_hi"], "active_lo": info["active_lo"],
           "u_range": [float(u.min()), float(u.max())],
           "kernel_launches": launches}
    emit(rep)
    if not all(ok for it in sys_.pdas_history
               for _, ok in it["linear_solves"]):
        raise AssertionError("oc_pdas: a linear solve missed its rtol")
    if not (u.min() >= lo - 1e-8 and u.max() <= hi + 1e-8):
        raise AssertionError(f"oc_pdas: u leaves [{lo}, {hi}]")
    if not (info["active_hi"] > 0 and info["active_lo"] > 0):
        raise AssertionError("oc_pdas: an active set is empty")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("oc_pdas: no B1 launch")
    return rep


def phase_oc_boundary() -> dict:
    """oc-boundary-128: Neumann boundary control, the same mesh and
    solver; the face assembly's device time beside the solve."""
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    sys_, ml_sol = oc_system("boundary", OC_COARSE, OC_LEVELS, "cuda",
                             OC_DTYPE, OC_RTOL)
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    a = sys_.assemblers[-1]
    u = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype, device="cuda")
    tables = a.device_tables_cached()
    R0 = torch.zeros(a.n_dofs, dtype=sys_.dtype, device="cuda")
    d0 = torch.zeros(a.pattern.n_rows * a.pattern.width, dtype=sys_.dtype,
                     device="cuda")
    # device time and wall time of the face terms alone and of the whole
    # assembly (volume and faces), each warm, under torch.profiler
    assemble = a.make_assemble_fn(pass_tables=True)
    timing = {}
    for name, fn in (("face_assembly", lambda: a._add_faces(
            u, tables, None, R0, d0, True)),
            ("assembly", lambda: assemble(u, tables))):
        fn()
        _, prof, wall = _profiled(fn)
        timing[name] = {"device_ms": prof["device_busy_s"] * 1e3,
                        "wall_ms": wall * 1e3,
                        "device_kernels": prof["n_kernels"]}
    xy = a.mesh.coords[a.dofmaps["u"].nodes]
    on_gc = np.abs(xy[:, 0] - 1.0) < 1e-9
    uc = ml_sol.sol[-1]["u"]
    off = float(np.abs(uc[~on_gc]).max())
    on = float(np.abs(uc[on_gc]).max())
    rep = {"phase": "oc_boundary", "config": "oc-boundary-128",
           "setup_s": setup_s, "wall_s": wall,
           "n_dofs": a.n_dofs, "newton_steps": len(sys_.history),
           "gmres_iters": [h["lin_iters"] for h in sys_.history],
           "step_seconds": [h["seconds"] for h in sys_.history],
           "linear_solves_converged": _solves_ok(sys_),
           "face_batches": len(a.face_batches),
           "faces": int(sum(b["fdofs"].shape[0] for b in a.face_batches)),
           **timing,
           "max_u_on_gc": on, "max_u_off_gc": off,
           "kernel_launches": launches,
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not rep["linear_solves_converged"]:
        raise AssertionError("oc_boundary: a linear solve missed its rtol")
    # eliminated control rows take corrections at the solve's tolerance
    if not (on > 0 and off <= OC_OFF_GC_MAX * on):
        raise AssertionError(f"oc_boundary: control off the control "
                             f"boundary ({off:.3g} against {on:.3g})")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("oc_boundary: no B1 launch")
    return rep


def phase_oc_theta() -> dict:
    """The bordered zero-mean control at 64x64 (operator="assembled": this
    phase launches no kernel)."""
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    sys_, ml_sol = oc_system("theta", OC_COARSE, OC_THETA_LEVELS, "cuda",
                             OC_DTYPE, OC_RTOL)
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    B = sys_._constraints[0][1]
    x = sys_.gather(-1)
    viol = float(abs(B @ x))
    bound = 1e-8 * float(np.linalg.norm(B) * np.linalg.norm(x))
    rep = {"phase": "oc_theta", "setup_s": setup_s, "wall_s": wall,
           "n_dofs": sys_.assemblers[-1].n_dofs,
           "theta": sys_.get_theta_value(),
           "newton_steps": len(sys_.history),
           "gmres_iters": [h["lin_iters"] for h in sys_.history],
           "linear_solves_converged": _solves_ok(sys_),
           "constraint_violation": viol, "violation_bound": bound,
           "kernel_launches": launch_counts(),
           "kernels": "none (operator='assembled': ELL gathers)"}
    emit(rep)
    if not rep["linear_solves_converged"]:
        raise AssertionError("oc_theta: a linear solve missed its rtol")
    if not viol <= bound:
        raise AssertionError(f"oc_theta: |B x - g| = {viol:.3g}")
    return rep


def fieldsplit_cavity(n: int, device, dtype):
    """The lid-driven cavity Jacobian of tests/test_fieldsplit_tree.py on
    unit_box((n, n)): u, v biquadratic, p linear (Taylor-Hood), nu 0.1, the
    pressure gauge, at the Dirichlet-lifted zero state; (assembler,
    operator, R) with the operator on the BELL-frame plan that System
    builds for it (bell_device_plan) from 2048 rows up."""
    from femus_tpu_torch.algebra.bell import bell_backed, bell_device_plan
    from femus_tpu_torch.assembly.bc import (apply_dirichlet_values,
                                             generate_bdc)
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.assembly.forms import navier_stokes
    from femus_tpu_torch.mesh.generation import unit_box

    a = Assembler(unit_box((n, n), "quad"),
                  [Unknown("u"), Unknown("v"), Unknown("p", "linear")],
                  quad_order="fifth", dtype=dtype, device=device)
    a.set_volume_form(navier_stokes(("u", "v"), "p", nu=0.1))
    generate_bdc(a, lambda var, x, grp, t: (
        (True, 1.0 if x[1] > 1 - 1e-12 else 0.0) if var == "u"
        else ((True, 0.0) if var == "v" else (False, 0.0))))
    mask, vals = a.dirichlet_mask.copy(), a.dirichlet_values.copy()
    mask[a.offsets["p"]] = True
    vals[a.offsets["p"]] = 0.0
    a.set_dirichlet(mask, vals)
    u0 = torch.as_tensor(apply_dirichlet_values(a, np.zeros(a.n_dofs)),
                         dtype=dtype, device=device)
    tables = a.device_tables_cached()
    R, data = a.make_assemble_fn(pass_tables=True)(u0, tables)
    A = a.op_with(data, tables["ell_cols"])
    note = {"path": "ell"}
    if a.n_dofs >= 2048:
        plan, note = bell_device_plan(a.pattern, "identity", device)
        A = bell_backed(plan, A)
    return a, A, R, note


def fieldsplit_preconditioners(a, A) -> dict:
    """The flat Schur split (Jacobi F-solve) and the nested tree of
    tests/test_fieldsplit_tree.py (Vanka velocity leaf, Jacobi pressure
    leaf, Schur "full", 12 Schur iterations)."""
    from femus_tpu_torch.algebra import fieldsplit as fs

    sv, sp_ = fs.splits_from_offsets(a, {"vel": ["u", "v"], "p": ["p"]})
    N = fs.FieldSplitNode
    tree = N("root", combine="schur", schur_fact="full", schur_iters=12,
             children=[N("vel", vars=["u", "v"], pc="vanka", iters=2,
                         vanka_block_elems=2),
                       N("press", vars=["p"], pc="jacobi", iters=2)])
    return {"flat": fs.schur_fieldsplit(A, sv, sp_, fs.jacobi_pc(A, sv.idx),
                                        fact="full"),
            "tree": fs.build_fieldsplit_tree(A, a, tree)}


def phase_fieldsplit() -> dict:
    """FGMRES(50) with FIELDSPLIT_RESTARTS restarts on the 128x128 cavity
    Jacobian, once per preconditioner."""
    from femus_tpu_torch.algebra.krylov import fgmres
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    a, A, R, note = fieldsplit_cavity(FIELDSPLIT_N, "cuda", torch.float32)
    Ms = fieldsplit_preconditioners(a, A)
    torch.cuda.synchronize()
    rep = {"phase": "fieldsplit", "n_dofs": a.n_dofs,
           "nnz": int(a.pattern.nnz), "setup_s": time.perf_counter() - t0,
           "routing": note, "restart": 50,
           "max_restarts": FIELDSPLIT_RESTARTS}
    reset_launches()
    rnorm = float(torch.linalg.norm(R))
    for name, M in Ms.items():
        n0 = launch_counts()["bell_spmv"]
        t0 = time.perf_counter()
        d, info = fgmres(A.matvec, -R, M=M, tol=1e-8, restart=50,
                         max_restarts=FIELDSPLIT_RESTARTS)
        torch.cuda.synchronize()
        rep[name] = {"seconds": time.perf_counter() - t0,
                     "iters": info.iters, "converged": info.converged,
                     "true_rel_residual": float(torch.linalg.norm(
                         A @ d + R)) / rnorm,
                     "finite": bool(torch.isfinite(d).all()),
                     "bell_launches": launch_counts()["bell_spmv"] - n0}
    rep["kernel_launches"] = launch_counts()
    emit(rep)
    if not (rep["flat"]["finite"] and rep["tree"]["finite"]):
        raise AssertionError("fieldsplit: non-finite correction")
    if not (rep["tree"]["true_rel_residual"]
            <= 1.5 * rep["flat"]["true_rel_residual"]):
        raise AssertionError("fieldsplit: the tree's residual is above "
                             "1.5x the flat split's")
    if rep["kernel_launches"]["bell_spmv"] <= 0:
        raise AssertionError("fieldsplit: no B1 launch")
    return rep


def poisson_q2_solver(device, dtype, bc=None, solves=None):
    """make_and_solve for convergence_study: Q2 Poisson -Lap u = 2 pi^2
    sin(pi x) sin(pi y), homogeneous Dirichlet (on every boundary face, or
    where ``bc`` says), operator="bell", MG-CG to rtol 1e-12.  With
    ``solves`` (a list), each solve's system, dofs, iterations, seconds and
    convergence are appended to it."""
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    pi = np.pi

    def make_and_solve(ml_mesh):
        ml_sol = MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u", "biquadratic")
        ml_sol.initialize("u")
        ml_sol.attach_bc(bc or (lambda var, x, grp, t: (True, 0.0)))
        ml_sol.generate_bdc("u")
        prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
        sys_ = prob.add_system(LinearImplicitSystem, "P")
        sys_.add_unknown("u")
        sys_.set_assembly(poisson("u", rhs=lambda x: 2 * pi * pi
                                  * torch.sin(pi * x[:, 0])
                                  * torch.sin(pi * x[:, 1])))
        cfg = sys_.config
        cfg.operator = "bell"
        cfg.outer = "cg"
        cfg.rtol = 1e-12
        sys_.init(device=device, dtype=dtype)
        t0 = time.perf_counter()
        info = sys_.solve()
        if solves is not None:
            solves.append({"system": sys_, "n_dofs": sys_.assemblers[-1].n_dofs,
                           "iters": info["iters"], "converged":
                           info["converged"],
                           "solve_s": time.perf_counter() - t0})
        if not info["converged"]:
            raise AssertionError(f"convergence: a solve missed rtol {info}")
        return ml_sol, {"u": "biquadratic"}

    return make_and_solve


def phase_convergence() -> dict:
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.systems.fe_convergence import convergence_study
    from femus_tpu_torch.systems.system import launch_counts

    pi = np.pi

    def exact(x):
        return torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])

    def exact_grad(x):
        return torch.stack([pi * torch.cos(pi * x[:, 0])
                            * torch.sin(pi * x[:, 1]),
                            pi * torch.sin(pi * x[:, 0])
                            * torch.cos(pi * x[:, 1])], dim=-1)

    reset_launches()
    t0 = time.perf_counter()
    res = convergence_study(poisson_q2_solver("cuda", torch.float64),
                            unit_box((CONV_COARSE, CONV_COARSE)),
                            CONV_LEVELS, {"u": exact}, {"u": exact_grad},
                            device="cuda")
    torch.cuda.synchronize()
    rep = {"phase": "convergence", "seconds": time.perf_counter() - t0,
           "finest_dofs": (2 * CONV_COARSE * 2 ** (CONV_LEVELS - 1) + 1) ** 2,
           "l2_errors": res.l2_errors["u"], "h1_errors": res.h1_errors["u"],
           "l2_orders": res.l2_orders["u"], "h1_orders": res.h1_orders["u"],
           "kernel_launches": launch_counts()}
    emit(rep)
    if not (res.l2_orders["u"][-1] > 2.7 and res.h1_orders["u"][-1] > 1.8):
        raise AssertionError(f"convergence: orders\n{res.report()}")
    if rep["kernel_launches"]["bell_spmv"] <= 0:
        raise AssertionError("convergence: no B1 launch")
    return rep


def phase_oc_reference() -> None:
    """Card against host in float64 at unit_box((4,4)), 2 levels: the
    distributed control after 3 PDAS iterations, the boundary control, the
    bordered theta solve, and one application of each field-split
    preconditioner to the same r on the 16x16 cavity (on the BELL frame on
    the card)."""
    got = {}
    for device in ("cuda", "cpu"):
        out = {}
        sys_, ml_sol = oc_system("distributed", 4, 2, device, torch.float64,
                                 1e-10)
        sys_.set_control_bounds("u", *OC_BOUNDS, alpha=OC_ALPHA)
        info = sys_.solve_pdas(max_iters=3)
        out["pdas"] = np.concatenate([ml_sol.sol[-1][v] for v in "ylu"])
        out["pdas_counts"] = [(h["active_hi"], h["active_lo"])
                              for h in sys_.pdas_history]
        sys_, ml_sol = oc_system("boundary", 4, 2, device, torch.float64,
                                 1e-10)
        sys_.solve()
        out["boundary"] = np.concatenate([ml_sol.sol[-1][v] for v in "ylu"])
        sys_, ml_sol = oc_system("theta", 4, 2, device, torch.float64, 1e-10)
        sys_.solve()
        out["theta"] = np.array([sys_.get_theta_value()])
        a, A, _, _ = fieldsplit_cavity(16, device, torch.float64)
        r = np.random.default_rng(5).standard_normal(a.n_dofs)
        r[a.dirichlet_mask] = 0.0
        for name, M in fieldsplit_preconditioners(a, A).items():
            out["fieldsplit_" + name] = M(torch.as_tensor(
                r, device=device)).cpu().numpy()
        got[device] = out
    rep = {"phase": "oc_reference",
           "pdas_counts": {d: got[d]["pdas_counts"] for d in got}}
    for k in ("pdas", "boundary", "theta", "fieldsplit_flat",
              "fieldsplit_tree"):
        ref = got["cpu"][k]
        rep[k] = float(np.abs(got["cuda"][k] - ref).max()
                       / max(np.abs(ref).max(), 1e-300))
    emit(rep)
    worst = max(rep[k] for k in ("pdas", "boundary", "theta",
                                 "fieldsplit_flat", "fieldsplit_tree"))
    if not (worst < 1e-8 and got["cuda"]["pdas_counts"]
            == got["cpu"]["pdas_counts"]):
        raise AssertionError(f"card and host slice-6 paths differ: {rep}")


def _levels_converged(sys_) -> bool:
    """Every level's Newton loop of the last solve ended below its
    nonlinear tolerance, and every linear solve met its rtol."""
    last = {}
    for h in sys_.history:
        last[h["level"]] = h
    return (all(max(h["eps"].values()) < sys_.config.nonlinear_tol
                for h in last.values())
            and all(h["converged"] for h in sys_.history))


def _res_norm(sys_) -> float:
    """||R(u)|| at the finest level's current state (one more assembly)."""
    a = sys_.assemblers[-1]
    u = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype, device=sys_.device)
    R, _ = a.make_assemble_fn(with_jacobian=False, pass_tables=True)(
        u, a.device_tables_cached(), sys_.aux_scalars, sys_._aux_arrays(-1))
    return float(torch.linalg.norm(R))


def phase_fsi_setup() -> tuple:
    from femus_tpu_torch.parallel import cases

    t0 = time.perf_counter()
    sys_ = cases.fsi_bed(FSI_COARSE, FSI_LEVELS, "cuda", FSI_DTYPE,
                         rtol=1e-4, transient=False, max_nonlinear=8)
    ml_sol = sys_.ml_sol
    setup_s = time.perf_counter() - t0
    levels = []
    for a, tr in zip(sys_.assemblers, sys_.transfers + [None]):
        lv = {"n_dofs": a.n_dofs, "nnz": int(a.pattern.nnz),
              "row_min": int(a.pattern.valid.sum(axis=1).min()),
              "row_max": int(a.pattern.valid.sum(axis=1).max())}
        if tr is not None:
            lv["rap_coarse_rows"] = tr[2].coarse_pattern.n_rows
            lv["rap_coarse_nnz"] = int(tr[2].coarse_pattern.nnz)
            lv["rap_triplets"] = int(tr[2].src.numel())
        levels.append(lv)
    emit({"phase": "fsi_setup", "seconds": setup_s,
          "n_dofs": sys_.assemblers[-1].n_dofs, "levels": levels,
          "restriction": "R A P (Petrov-Galerkin, pairs u->dx, v->dy)"})
    return sys_, ml_sol, setup_s


def _fsi_observables(sys_, ml_sol) -> dict:
    """max |u| in the fluid and max |dx| on the interface y = FSI_BED."""
    from femus_tpu_torch.parallel.cases import FSI_BED

    mesh = sys_.ml_mesh.levels[-1]
    xy = mesh.coords[mesh.dofmap("biquadratic").nodes]
    sol = ml_sol.sol[-1]
    fluid = xy[:, 1] > FSI_BED + 1e-9
    iface = np.isclose(xy[:, 1], FSI_BED)
    return {"max_u_fluid": float(np.abs(sol["u"][fluid]).max()),
            "max_dx_interface": float(np.abs(sol["dx"][iface]).max())}


def phase_fsi_main(sys_, ml_sol, setup_s: float) -> dict:
    """NonLinearImplicitSystem.solve on fsi-bed-64, with the launch
    counts set to 0 just before it and read just after."""
    from femus_tpu_torch.parallel.cases import FSI_FIELDS
    from femus_tpu_torch.systems.system import launch_counts

    res0 = _res_norm(sys_)               # the finest level's initial state
    reset_launches()
    _flush_buffer.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = sys_.history
    for h in hist:
        emit({"phase": "fsi_newton_step", "level": h["level"],
              "it": h["newton_it"], "seconds": h["seconds"],
              "fgmres_iters": h["lin_iters"], "lin_res": h["lin_res"],
              "lin_target": h["lin_target"], "converged": h["converged"],
              "res_norm": h["res_norm"],
              "kernel_launches": h["kernel_launches"], "eps": h["eps"]})
    fine = [h for h in hist if h["level"] == len(sys_.assemblers) - 1]
    final_res = _res_norm(sys_)
    drop = res0 / max(final_res, 1e-300)
    fields_ok = all(np.all(np.isfinite(ml_sol.sol[l][n]))
                    for l in range(len(ml_sol.sol)) for n in FSI_FIELDS)
    rep = {"phase": "fsi_main", "wall_s": wall, "setup_s": setup_s,
           "newton_steps": len(hist), "fine_newton_steps": len(fine),
           "fine_step_seconds": [h["seconds"] for h in fine],
           "fine_first_step_s": fine[0]["seconds"],
           "fine_steady_step_s": (float(np.mean([h["seconds"]
                                                 for h in fine[1:]]))
                                  if len(fine) > 1 else None),
           "fine_fgmres_iters": [h["lin_iters"] for h in fine],
           "fine_res_norm": [h["res_norm"] for h in fine],
           "initial_res_norm": res0, "final_res_norm": final_res,
           "res_norm_drop": drop,
           "kernel_launches": launches,
           "all_converged": _levels_converged(sys_),
           "linear_solves_converged": all(h["converged"] for h in hist),
           "tensors_on_cuda": _all_on_cuda(sys_), "fields_finite": fields_ok,
           "peak_device_bytes": peak,
           "n_dofs": [a.n_dofs for a in sys_.assemblers],
           **_fsi_observables(sys_, ml_sol),
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not rep["linear_solves_converged"]:
        raise AssertionError("fsi_main: a linear solve missed its rtol")
    if not drop >= 1e3:
        raise AssertionError(f"fsi_main: ||R(u)|| fell only {drop:.3g}x")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("fsi_main: the solve launched no B1")
    if not (fields_ok and rep["tensors_on_cuda"]):
        raise AssertionError("fsi_main: tensors off the card or non-finite "
                             "fields")
    return rep


def phase_fsi_transient() -> dict:
    """fsi-bed-transient-64: FSI_TRANSIENT_STEPS x time_step()."""
    from femus_tpu_torch.parallel.cases import FSI_DT, FSI_FIELDS, fsi_bed
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    sys_ = fsi_bed(FSI_COARSE, FSI_TRANSIENT_LEVELS, "cuda", FSI_DTYPE,
                   rtol=1e-4, max_nonlinear=8)
    ml_sol = sys_.ml_sol
    setup_s = time.perf_counter() - t0
    solid = ml_sol.ml_mesh.levels[-1].elem_group == 1
    bed = np.unique(ml_sol.ml_mesh.levels[-1].dofmap("biquadratic")
                    .conn[solid])
    reset_launches()
    steps, means = [], []
    for k in range(FSI_TRANSIENT_STEPS):
        t0 = time.perf_counter()
        sys_.time_step()
        torch.cuda.synchronize()
        fine = [h for h in sys_.history
                if h["level"] == len(sys_.assemblers) - 1]
        means.append(float(ml_sol.sol[-1]["u"][bed].mean()))
        steps.append({"time": sys_.time,
                      "seconds": time.perf_counter() - t0,
                      "newton_steps": len(sys_.history),
                      "fine_newton_steps": len(fine),
                      "fine_res_norm": [h["res_norm"] for h in fine],
                      "fine_fgmres_iters": [h["lin_iters"] for h in fine],
                      "converged": _levels_converged(sys_),
                      "solid_mean_u": means[-1]})
    launches = launch_counts()
    finite = all(np.all(np.isfinite(ml_sol.sol[l][n]))
                 for l in range(len(ml_sol.sol)) for n in FSI_FIELDS)
    rep = {"phase": "fsi_transient", "setup_s": setup_s,
           "n_dofs": [a.n_dofs for a in sys_.assemblers], "dt": FSI_DT,
           "steps": steps, "kernel_launches": launches,
           "fields_finite": finite,
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not all(st["converged"] for st in steps):
        raise AssertionError("fsi_transient: a time step's Newton solve "
                             "did not converge")
    if not all(abs(b - a) > 1e-9 for a, b in zip(means, means[1:])):
        raise AssertionError(f"fsi_transient: the solid stands still {means}")
    if not finite:
        raise AssertionError("fsi_transient: non-finite fields")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("fsi_transient: no B1 launch")
    return rep


def phase_fsi_reference() -> None:
    """Steady FSI (pairs, material Vanka, MG) and two transient steps on
    unit_box((4,4)), 2 levels: the card's float32 against the host's
    float64, every field."""
    from femus_tpu_torch.parallel.cases import FSI_FIELDS, fsi_bed

    rep = {"phase": "fsi_reference"}
    for case in ("steady", "transient"):
        fields = {}
        for device, dtype in (("cuda", FSI_DTYPE), ("cpu", torch.float64)):
            # at lid 0.2 the 8x8 Newton from the 4x4 solution wanders
            # (host, float64); at 0.02 it converges
            sys_ = fsi_bed(4, 2, device, dtype, rtol=1e-6,
                           transient=case == "transient", lid=0.02,
                           max_nonlinear=8)
            ml_sol = sys_.ml_sol
            if case == "steady":
                sys_.solve()
            else:
                for _ in range(2):
                    sys_.time_step()
            fields[device] = {n: ml_sol.sol[-1][n].copy()
                              for n in FSI_FIELDS}
        rep[case] = {n: float(np.linalg.norm(fields["cuda"][n]
                                              - fields["cpu"][n])
                              / max(np.linalg.norm(fields["cpu"][n]),
                                    1e-300))
                     for n in FSI_FIELDS}
    rep["n_dofs"] = int(sum(v.size for v in fields["cpu"].values()))
    emit(rep)
    worst = max(v for case in ("steady", "transient")
                for v in rep[case].values())
    if not worst < 1e-3:
        raise AssertionError(f"card and host FSI solutions differ: {rep}")


def run_slice6(profile: bool = False) -> dict:
    """The slice-6 phases in order; their reports by short name."""
    osys, osol, _ = phase_oc_setup()
    out = {"kernel": phase_kernel(osys, "oc_kernel")}
    out["main"] = phase_oc_main(osys, osol)
    if profile:
        phase_profile(osys, torch.as_tensor(
            osys.gather(-1), dtype=osys.dtype, device="cuda"),
            "oc-distributed-128")
    out["pdas"] = phase_oc_pdas(osys, osol)
    del osys, osol
    out["boundary"] = phase_oc_boundary()
    phase_oc_theta()
    out["fieldsplit"] = phase_fieldsplit()
    out["convergence"] = phase_convergence()
    phase_oc_reference()
    return out


@contextlib.contextmanager
def b1_tally():
    """B1 launches by the row count of the operator launched on, while the
    block runs: a shim around ``BellOp.matvec_frame``, which launches B1
    once for a CUDA vector (the kernel's wrapper keeps its own count)."""
    from femus_tpu_torch.algebra import bell
    orig, tally = bell.BellOp.matvec_frame, {}

    def shim(op, xf):
        y = orig(op, xf)
        if xf.is_cuda:
            tally[op.dev.n] = tally.get(op.dev.n, 0) + 1
        return y

    bell.BellOp.matvec_frame = shim
    try:
        yield tally
    finally:
        bell.BellOp.matvec_frame = orig


@contextlib.contextmanager
def cycle_dtype(builder: str, dtype):
    """Build the system layer's ``builder`` hierarchies
    (build_hierarchy_from_ops, build_hierarchy_matfree) with
    ``compute_dtype=dtype`` while the block runs (SolverConfig has no
    compute_dtype)."""
    from femus_tpu_torch.systems import system
    orig = getattr(system, builder)
    setattr(system, builder, functools.partial(orig, compute_dtype=dtype))
    try:
        yield
    finally:
        setattr(system, builder, orig)


def _bell_rows(sys_) -> set:
    """Row counts of the operators a system routed onto the BELL frame."""
    return {n["n_rows"] for n in sys_.solver_info()["routing"]
            if n.get("path") == "bell"}


def phase_rediscretize(galerkin: dict) -> dict:
    """cavity-128-rediscretize: cavity-128 with stacked dofs, every coarse
    level re-assembled on its own mesh at the restricted state per Newton
    step (Vanka on each level's own pattern, B1 on every level above 2048
    rows); against cavity-128's Galerkin solution of this run
    (``galerkin``: its fields and Newton history)."""
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    sys_, ml_sol = cavity_system(COARSE_CELLS, LEVELS, "cuda", torch.float32,
                                 rtol=1e-4, max_nonlinear=5,
                                 interleave_dofs=False,
                                 coarse_op="rediscretize")
    setup_s = time.perf_counter() - t0
    reset_launches()
    with b1_tally() as tally:
        t0 = time.perf_counter()
        sys_.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hist = sys_.history
    launches = launch_counts()["bell_spmv"]
    drop = hist[0]["res_norm"] / max(hist[-1]["res_norm"], 1e-300)
    bell_rows = sorted(_bell_rows(sys_))
    rel = {n: float(np.linalg.norm(ml_sol.sol[-1][n] - galerkin["fields"][n])
                    / max(np.linalg.norm(galerkin["fields"][n]), 1e-300))
           for n in ("u", "v", "p")}
    rep = {"phase": "rediscretize", "setup_s": setup_s, "wall_s": wall,
           "levels": [a.n_dofs for a in sys_.assemblers],
           "gmres_iters": [h["lin_iters"] for h in hist],
           "step_seconds": [h["seconds"] for h in hist],
           "galerkin_gmres_iters": [h["lin_iters"]
                                    for h in galerkin["history"]],
           "galerkin_step_seconds": [h["seconds"]
                                     for h in galerkin["history"]],
           "res_norms": [h["res_norm"] for h in hist],
           "res_norm_drop": drop,
           "all_converged": all(h["converged"] for h in hist),
           "b1_launches_by_rows": {str(k): v for k, v in
                                   sorted(tally.items())},
           "bell_levels": bell_rows, "rel_diff_vs_galerkin": rel,
           "kernel_launches": launch_counts(),
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not rep["all_converged"]:
        raise AssertionError("rediscretize: a linear solve missed its rtol")
    if not drop >= 1e3:
        raise AssertionError(f"rediscretize: ||R(u)|| fell only {drop:.3g}x")
    levels = [a.n_dofs for a in sys_.assemblers]
    want = {n for n in levels[1:] if n >= 2048}
    if not (want and set(bell_rows) == want
            and all(tally.get(n, 0) > 0 for n in want)):
        raise AssertionError("rediscretize: B1 did not run on every level "
                             f"above the threshold: {tally}, {levels}")
    if not max(rel.values()) < 1e-3:
        raise AssertionError(f"rediscretize: differs from Galerkin: {rel}")
    return {**rep, "launches": launches}


def lshape_mesh(n: int):
    """(-1, 1)^2 minus (0, 1)^2 from box((n, n)) (tests/test_amr.py's
    L-shape at n = 2 before its refine), one boundary group."""
    from femus_tpu_torch.mesh.generation import box

    m0 = box((n, n), [(-1.0, 1.0), (-1.0, 1.0)], "quad")
    cent = m0.coords[m0.conn[:, :4]].mean(axis=1)
    return _submesh(m0, ~((cent[:, 0] > 0) & (cent[:, 1] > 0)),
                    lambda c: 1)


def lshape_exact(x, xp=np):
    """The corner singularity u = r^(2/3) sin(2 phi / 3) of the L-shape,
    phi = theta - pi/2 in [0, 3 pi/2] measured from the positive y axis
    through the domain to the positive x axis: harmonic in the domain,
    zero on both re-entrant edges.  (tests/test_amr.py writes
    sin(2 (theta + pi/2) / 3) with theta cut at -pi/2, a cut that runs
    through this domain along x = 0, y < 0: that function jumps by up to
    0.87 r^(2/3) there and solves no boundary-value problem on it.)"""
    atan2 = np.arctan2 if xp is np else torch.atan2
    th = atan2(x[:, 1], x[:, 0])
    # theta in [pi/2, 5 pi/2): the cut lies in the removed quadrant
    th = xp.where(th < np.pi / 2 - 1e-12, th + 2 * np.pi, th)
    return xp.hypot(x[:, 0], x[:, 1]) ** (2.0 / 3) * xp.sin(
        2 * (th - np.pi / 2) / 3)


def amr_problem():
    """(unknowns, volume form, bc) of Q2 Poisson with the exact L-shape
    solution as Dirichlet data on the whole boundary."""
    from femus_tpu_torch.assembly.engine import Unknown
    from femus_tpu_torch.assembly.forms import poisson

    def bc(var, x, grp, t):
        return True, float(lshape_exact(x[None, :])[0])

    return [Unknown("u")], poisson("u"), bc


def phase_amr() -> dict:
    """amr-lshape: AMR_CYCLES cycles of solve_mg_amr over the chain so far
    (float64, B1 on every reduced level but the LU-solved coarsest), Kelly,
    flag_by_error(AMR_FRACTION, "fraction"), refine_selective; per cycle
    elements, dofs, hanging dofs, iterations, residual, L2 error, host
    set-up and solve seconds, B1 launches by level; then B1 on the finest
    reduced operator, and solve_conforming on the last cycle with at most
    AMR_CONFORMING_MAX_DOFS dofs."""
    from femus_tpu_torch.algebra.bell import bell_device_plan
    from femus_tpu_torch.assembly.norms import error_norms
    from femus_tpu_torch.mesh.amr import flag_by_error, refine_selective
    from femus_tpu_torch.systems import amr
    from femus_tpu_torch.systems.system import launch_counts

    problem = amr_problem()
    meshes = [lshape_mesh(AMR_COARSE)]
    cycles, check = [], None
    reset_launches()
    t_all = time.perf_counter()
    for cyc in range(AMR_CYCLES):
        m = meshes[-1]
        n0 = launch_counts()["bell_spmv"]
        with b1_tally() as tally:
            u, info = amr.solve_mg_amr(meshes, *problem, tol=AMR_TOL,
                                       device="cuda", dtype=torch.float64)
        n_dofs = m.dofmap("biquadratic").n_dofs
        l2, _ = error_norms(m, "biquadratic", torch.as_tensor(
            u[:n_dofs], device="cuda"), lambda x: lshape_exact(x, torch),
            device="cuda")
        t0 = time.perf_counter()
        eta = amr.kelly_indicator(m, "biquadratic", u[:n_dofs])
        row = {"cycle": cyc, "elements": m.n_elems, "dofs": n_dofs,
               "hanging": info["n_hanging"], "levels": info["n_levels"],
               "cg_iters": info["iterations"],
               "residual": info["residual"], "target": info["target"],
               "converged": info["converged"], "l2_error": l2,
               "max_elem_level": int(np.max(m.elem_level))
               if m.elem_level is not None else 0,
               "setup_s": info["setup_seconds"],
               "solve_s": info["solve_seconds"],
               "kelly_s": time.perf_counter() - t0,
               "b1_launches": launch_counts()["bell_spmv"] - n0,
               "b1_launches_by_rows": {str(k): v for k, v in
                                       sorted(tally.items())},
               "routing": [(r["n_rows"], r["path"])
                           for r in info["routing"]]}
        emit({"phase": "amr_cycle", **row})
        cycles.append(row)
        if n_dofs <= AMR_CONFORMING_MAX_DOFS:
            check = (m, u, info["iterations"], cyc)
        if cyc < AMR_CYCLES - 1:
            t0 = time.perf_counter()
            meshes.append(refine_selective(m, flag_by_error(
                eta, AMR_FRACTION, mode="fraction")))
            row["refine_s"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_all
    launches = launch_counts()["bell_spmv"]
    # the single-level diagonal CG on the largest mesh it stays cheap on
    m, u_mg, mg_iters, cyc = check
    t0 = time.perf_counter()
    u_sc, info_sc = amr.solve_conforming(m, *problem, tol=AMR_TOL,
                                         maxiter=20000, device="cuda",
                                         dtype=torch.float64)
    conforming = {"cycle": cyc, "dofs": m.dofmap("biquadratic").n_dofs,
                  "mg_iters": mg_iters, "cg_iters": info_sc["iterations"],
                  "seconds": time.perf_counter() - t0,
                  "rel_diff": float(np.linalg.norm(u_mg - u_sc)
                                    / np.linalg.norm(u_sc))}
    # B1 on the finest reduced operator, in the plan the solve builds
    asm, C, free_idx, mask_f, sched = amr._reduced_system(
        meshes[-1], *problem, device="cuda", dtype=torch.float64)
    A, _, _ = amr._reduced_op(asm, C, free_idx, mask_f, sched, amr._start(
        asm, C, free_idx, torch.float64, torch.device("cuda")))
    dev, _ = bell_device_plan(sched.coarse_pattern, "identity", "cuda")
    k = b1_rows(A.data, sched.coarse_pattern, dev, "amr_kernel",
                (("f64", torch.float64),))
    del A, asm, sched, dev
    errs = [c["l2_error"] for c in cycles]
    rep = {"phase": "amr", "wall_s": wall, "cycles": len(cycles),
           "finest_elements": cycles[-1]["elements"],
           "finest_dofs": cycles[-1]["dofs"], "l2_errors": errs,
           "cg_iters": [c["cg_iters"] for c in cycles],
           "setup_s": [c["setup_s"] for c in cycles],
           "solve_s": [c["solve_s"] for c in cycles],
           "conforming": conforming, "kernel_launches": launch_counts()}
    emit(rep)
    bad = [c["cycle"] for i, c in enumerate(cycles)
           if not (c["converged"] and c["cg_iters"] <= (
               AMR_MAX_ITERS if c["dofs"] <= AMR_CONFORMING_MAX_DOFS
               else cycles[i - 1]["cg_iters"] + AMR_ITER_GROWTH))]
    if bad:
        raise AssertionError(f"amr: MG-CG convergence or iterations on "
                             f"cycles {bad}")
    if not all(e2 < e1 for e1, e2 in zip(errs, errs[1:])):
        raise AssertionError(f"amr: the L2 error did not fall: {errs}")
    if not cycles[-1]["max_elem_level"] >= 2:
        raise AssertionError("amr: the corner was not refined twice")
    if not (conforming["mg_iters"] < conforming["cg_iters"] / 3
            and conforming["rel_diff"] < 1e-9):
        raise AssertionError(f"amr: against solve_conforming: {conforming}")
    for c in cycles[1:]:
        # every reduced level but the LU-solved coarsest runs on B1
        want = {n for n, path in c["routing"] if path == "bell"}
        if not (want and all(c["b1_launches_by_rows"].get(str(n), 0) > 0
                             for n in want)
                and all(path != "ell" or n < 2048
                        for n, path in c["routing"])):
            raise AssertionError(f"amr: B1 missing on a level: {c}")
    return {**k, "launches": launches}


def phase_amr_reference() -> None:
    """A 3-cycle chain from unit_box((4,4)) (the Poisson problem of
    tests/test_mg_amr.py), refined by the host's flags: solve_mg_amr on
    the card and on the host in float64 must agree to 1e-10 with equal
    iteration counts on every cycle."""
    from femus_tpu_torch.assembly.engine import Unknown
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.mesh.amr import flag_by_error, refine_selective
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.systems import amr

    pi = np.pi
    problem = ([Unknown("u")], poisson("u", rhs=lambda x: 2 * pi ** 2
                                       * torch.sin(pi * x[:, 0])
                                       * torch.sin(pi * x[:, 1])),
               lambda var, x, grp, t: (True, 0.0))
    meshes = [unit_box((4, 4))]
    rep = {"phase": "amr_reference", "rel_diff": [], "iters": []}
    for cyc in range(3):
        out = {}
        for device in ("cuda", "cpu"):
            out[device] = amr.solve_mg_amr(meshes, *problem, device=device,
                                           dtype=torch.float64)
        (uc, ic), (uh, ih) = out["cuda"], out["cpu"]
        rep["rel_diff"].append(float(np.abs(uc - uh).max()
                                     / np.abs(uh).max()))
        rep["iters"].append((ic["iterations"], ih["iterations"]))
        m = meshes[-1]
        eta = amr.kelly_indicator(m, "biquadratic",
                                  uh[:m.dofmap("biquadratic").n_dofs])
        if cyc < 2:
            meshes.append(refine_selective(m, flag_by_error(eta, 0.3,
                                                            "fraction")))
    rep["n_dofs"] = int(uh.size)
    emit(rep)
    if not (max(rep["rel_diff"]) < 1e-10
            and all(a == b for a, b in rep["iters"])):
        raise AssertionError(f"card and host AMR solves differ: {rep}")


def run_slice7() -> dict:
    """The slice-7 AMR phases; their reports by short name."""
    out = {"amr": phase_amr()}
    phase_amr_reference()
    return out


# ---- slice 8: the remaining forms, surface FE, the batch-first layout,
# mixed-element meshes and the nonlocal operator (kernel B1) ---------------

def heated_cavity_bc(var, x, grp, t):
    """The de Vahl Davis walls: no-slip everywhere, T = 0.5 on x = 0 and
    -0.5 on x = 1, insulated top and bottom."""
    if var in ("u", "v"):
        return True, 0.0
    if var == "T":
        if abs(x[0]) < 1e-9:
            return True, 0.5
        if abs(x[0] - 1.0) < 1e-9:
            return True, -0.5
    return False, 0.0


def boussinesq_system(coarse: int, levels: int, device, dtype, rtol: float,
                      max_nonlinear: int):
    """The differentially heated cavity through the port's public entry
    points, configured as cavity-128 (RCM, interleaved dofs,
    operator="bell", Vanka V-cycle GMRES(60)); the pressure is pinned at
    its first dof, as in the lid-driven cavity."""
    from femus_tpu_torch.assembly.forms import boussinesq
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import NonLinearImplicitSystem

    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    rcm_reorder_hierarchy(ml_mesh)
    ml_sol = MultiLevelSolution(ml_mesh)
    for n in ("u", "v", "T"):
        ml_sol.add_solution(n, "biquadratic")
    ml_sol.add_solution("p", "disc_linear")
    for n in ("u", "v", "p", "T"):
        ml_sol.initialize(n)
    ml_sol.attach_bc(heated_cavity_bc)
    ml_sol.generate_bdc("u", "v", "p", "T")
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(NonLinearImplicitSystem, "Boussinesq")
    sys_.add_unknown("u", "v", "p", "T")
    sys_.set_assembly(boussinesq(("u", "v"), "p", "T",
                                 pres_family="disc_linear", ra=BOUS_RA,
                                 pr=BOUS_PR))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.mg_type = "V"
    cfg.rtol = rtol
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.max_nonlinear = max_nonlinear
    sys_.init(device=device, dtype=dtype)
    return sys_, ml_sol


def hot_wall_nusselt(mesh, T: np.ndarray, device) -> float:
    """Nu = -int_0^1 dT/dx(0, y) dy from the wall elements' Q2 values of T,
    in float64: a volume face form integrates dT/dx phi_i over the faces
    of group 1 (x = 0) and the residual is summed over i (the basis sums to
    one)."""
    from femus_tpu_torch.assembly.engine import Assembler, Unknown

    a = Assembler(mesh, [Unknown("T")], dtype=torch.float64, device=device)
    a.set_volume_form(lambda ops, u, aux: {})

    def wall_flux(fops, u, grp, aux):
        g = fops.grad("biquadratic", u["T"])[:, 0]
        return {"T": fops.t("biquadratic", g * (grp == 1).to(g.dtype))}

    a.set_face_form(wall_flux, volume=True)
    R, _ = a.make_assemble_fn(with_jacobian=False)(
        torch.as_tensor(T, dtype=torch.float64, device=device))
    return -float(R.sum())


def cavity_observables(mesh, sol: dict, device) -> dict:
    """Nu on the hot wall, u_max on x = 0.5 and v_max on y = 0.5 in units
    of kappa / L (nodal values times sqrt(Ra Pr)), and the range of T."""
    x = mesh.coords[mesh.dofmap("biquadratic").nodes]
    scale = np.sqrt(BOUS_RA * BOUS_PR)
    return {"nu": hot_wall_nusselt(mesh, sol["T"], device),
            "u_max": float(sol["u"][np.abs(x[:, 0] - 0.5) < 1e-9].max())
            * scale,
            "v_max": float(sol["v"][np.abs(x[:, 1] - 0.5) < 1e-9].max())
            * scale,
            "t_min": float(sol["T"].min()), "t_max": float(sol["T"].max())}


def phase_bous_main(sys_, ml_sol, setup_s: float) -> dict:
    """The slice's main path: the Boussinesq Newton solve of
    boussinesq-cavity-128 on the card, with the de Vahl Davis gates."""
    from femus_tpu_torch.systems.system import launch_counts

    reset_launches()
    _flush_buffer.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist = sys_.history
    for h in hist:
        emit({"phase": "bous_step", "it": h["newton_it"],
              "seconds": h["seconds"], "gmres_iters": h["lin_iters"],
              "lin_res": h["lin_res"], "lin_target": h["lin_target"],
              "converged": h["converged"], "res_norm": h["res_norm"],
              "kernel_launches": h["kernel_launches"], "eps": h["eps"]})
    drop = hist[0]["res_norm"] / max(hist[-1]["res_norm"], 1e-300)
    sol = {n: ml_sol.sol[-1][n] for n in ("u", "v", "p", "T")}
    obs = cavity_observables(sys_.ml_mesh.finest(), sol, "cuda")
    rel = {k: abs(obs[k] - v) / v for k, v in BOUS_BENCH.items()}
    rep = {"phase": "bous_main", "setup_s": setup_s, "wall_s": wall,
           "newton_steps": len(hist),
           "gmres_iters": [h["lin_iters"] for h in hist],
           "step_seconds": [h["seconds"] for h in hist],
           "res_norm_drop": drop,
           "all_converged": all(h["converged"] for h in hist),
           "observables": obs, "benchmark": BOUS_BENCH, "rel_err": rel,
           "kernel_launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "levels": [a.n_dofs for a in sys_.assemblers],
           "fields_finite": all(np.all(np.isfinite(v)) for v in sol.values()),
           "tensors_on_cuda": _all_on_cuda(sys_),
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not rep["all_converged"]:
        raise AssertionError("bous_main: a linear solve missed its rtol")
    if not drop >= 1e3:
        raise AssertionError(f"bous_main: ||R(u)|| fell only {drop:.3g}x")
    if not (obs["t_min"] >= -0.5 - 1e-3 and obs["t_max"] <= 0.5 + 1e-3):
        raise AssertionError(f"bous_main: T left [-0.5, 0.5]: {obs}")
    if not max(rel.values()) <= BOUS_TOL:
        raise AssertionError(f"bous_main: off the benchmark: {rel}")
    if not (launches["bell_spmv"] > 0 and rep["fields_finite"]
            and rep["tensors_on_cuda"]):
        raise AssertionError("bous_main: no B1 launch, tensors off the "
                             "card or non-finite fields")
    return rep


def phase_bous_reference() -> None:
    """The heated cavity on unit_box((4,4)), 3 levels: the card's float32
    solve against the host's float64, every field to 1e-3 relative."""
    from femus_tpu_torch.systems.system import launch_counts

    fields, runs = {}, {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        t0 = time.perf_counter()
        sys_, ml_sol = boussinesq_system(4, 3, device, dtype, rtol=1e-6,
                                         max_nonlinear=5)
        n0 = launch_counts()["bell_spmv"]
        sys_.solve()
        fields[device] = {n: ml_sol.sol[-1][n].copy()
                          for n in ("u", "v", "p", "T")}
        runs[device] = {"seconds": time.perf_counter() - t0,
                        "gmres_iters": [h["lin_iters"]
                                        for h in sys_.history],
                        "b1_launches": launch_counts()["bell_spmv"] - n0}
    rel = {n: float(np.linalg.norm(fields["cuda"][n] - ref)
                    / np.linalg.norm(ref))
           for n, ref in fields["cpu"].items()}
    emit({"phase": "bous_reference", "rel_diff": rel, "runs": runs,
          "n_dofs": int(sum(f.size for f in fields["cpu"].values()))})
    if not max(rel.values()) < 1e-3:
        raise AssertionError(f"card and host Boussinesq differ: {rel}")


def sphere_cap(x, xp=np):
    """The R = WILLMORE_R sphere cap over the unit square and its
    curvature field: (u, W = -1/u)."""
    u = xp.sqrt(WILLMORE_R ** 2 - (x[:, 0] - 0.5) ** 2 - (x[:, 1] - 0.5) ** 2)
    return u, -1.0 / u


def forms_system(kind: str, coarse: int, levels: int, dtype):
    """One solve of forms-128 through the port's public entry points:
    "biharmonic" (coupled, u = sin(pi x) sin(pi y), Chebyshev V-cycle
    GMRES(60) to 1e-10, LinearImplicitSystem) or "willmore" (the sphere
    cap from its interpolant, Vanka V-cycle GMRES(60), seventh-order
    quadrature, Newton to nonlinear_tol 1e-11); operator="bell"."""
    from femus_tpu_torch.assembly.forms import (biharmonic_coupled,
                                                willmore_graph)
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import (LinearImplicitSystem,
                                                NonLinearImplicitSystem)

    pi = np.pi
    names = ("u", "v") if kind == "biharmonic" else ("u", "W")
    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    for n in names:
        ml_sol.add_solution(n, "biquadratic")
    if kind == "biharmonic":
        for n in names:
            ml_sol.initialize(n)
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    else:
        ml_sol.initialize("u", lambda x: sphere_cap(x)[0])
        ml_sol.initialize("W", lambda x: sphere_cap(x)[1])
        ml_sol.attach_bc(lambda var, x, grp, t: (True, float(
            sphere_cap(x[None])[0 if var == "u" else 1][0])))
    ml_sol.generate_bdc()
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order=(
        "fifth" if kind == "biharmonic" else "seventh"))
    if kind == "biharmonic":
        sys_ = prob.add_system(LinearImplicitSystem, "BH")
        sys_.set_assembly(biharmonic_coupled(
            rhs=lambda x: 4 * pi ** 4 * torch.sin(pi * x[:, 0])
            * torch.sin(pi * x[:, 1])))
    else:
        sys_ = prob.add_system(NonLinearImplicitSystem, "Willmore")
        sys_.set_assembly(willmore_graph("u", "W"))
    sys_.add_unknown(*names)
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.smoother = "chebyshev" if kind == "biharmonic" else "vanka"
    cfg.rtol = 1e-10
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.max_nonlinear = 8
    cfg.nonlinear_tol = 1e-11
    sys_.init(device="cuda", dtype=dtype)
    return sys_, ml_mesh, ml_sol


def phase_forms() -> dict:
    """forms-128: each form solved at FORMS_LEVELS - 1 and FORMS_LEVELS
    levels; L2 errors (norms on the card), the order between the two, and
    the biharmonic's v against its exact 2 pi^2 u."""
    from femus_tpu_torch.assembly.norms import error_norms
    from femus_tpu_torch.systems.system import launch_counts

    pi = np.pi
    exact_bh = lambda x: torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])  # noqa
    out, launches = {}, 0
    for kind in ("biharmonic", "willmore"):
        rows = []
        for levels in (FORMS_LEVELS - 1, FORMS_LEVELS):
            reset_launches()
            t0 = time.perf_counter()
            sys_, ml_mesh, ml_sol = forms_system(kind, FORMS_COARSE, levels,
                                                 torch.float64)
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            info = sys_.solve()
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            mesh = ml_mesh.finest()
            if kind == "biharmonic":
                err = error_norms(mesh, "biquadratic", ml_sol.sol[-1]["u"],
                                  exact_bh, device="cuda")[0]
                err_v = error_norms(mesh, "biquadratic", ml_sol.sol[-1]["v"],
                                    lambda x: 2 * pi ** 2 * exact_bh(x),
                                    device="cuda")[0] / (2 * pi ** 2)
                solves = [info]
                row = {"l2_error_v_over_2pi2": err_v}
            else:
                err = error_norms(mesh, "biquadratic", ml_sol.sol[-1]["u"],
                                  lambda x: sphere_cap(x, torch)[0],
                                  device="cuda")[0]
                solves = sys_.history
                row = {"newton_steps": len(solves),
                       "eps": solves[-1]["eps"]}
            row.update({"levels": levels, "n_dofs": sys_.assemblers[-1].n_dofs,
                        "setup_s": setup_s, "solve_s": solve_s,
                        "gmres_iters": [h.get("iters", h.get("lin_iters"))
                                        for h in solves],
                        "converged": all(h["converged"] for h in solves),
                        "l2_error": err,
                        "b1_launches": launch_counts()["bell_spmv"]})
            row["b1_held"] = b1_on_system(sys_)
            launches += row["b1_launches"]
            rows.append(row)
            del sys_, ml_mesh, ml_sol
        order = float(np.log2(rows[0]["l2_error"] / rows[1]["l2_error"]))
        out[kind] = {"rows": rows, "l2_order": order}
        emit({"phase": "forms", "form": kind, "l2_order": order,
              "rows": rows})
    bh, wm = out["biharmonic"], out["willmore"]
    if not all(r["converged"] for f in (bh, wm) for r in f["rows"]):
        raise AssertionError("forms: a solve missed its rtol")
    if not solves_on_b1(bh["rows"] + wm["rows"]):
        raise AssertionError("forms: no B1 launch, or B1 disagrees")
    if not (bh["l2_order"] > 2.3 and all(
            r["l2_error_v_over_2pi2"] <= 10 * r["l2_error"]
            for r in bh["rows"])):
        raise AssertionError(f"forms: biharmonic gates: {bh}")
    if not (wm["l2_order"] > 2.5
            and all(r["newton_steps"] <= 8 for r in wm["rows"])):
        raise AssertionError(f"forms: Willmore gates: {wm}")
    return {"launches": launches}


def b1_on_operator(op) -> dict:
    """B1 against its plain version on the frame operator ``op`` of a path
    (a ``BellBackedOp``'s ``bell``), in its value type, on a seeded x."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(op.dev.n, generator=gen, dtype=op.vals.dtype)
    return b1_held(op, x.to(op.vals.device),
                   1e-12 if op.vals.dtype == torch.float64 else 1e-5)


def b1_on_system(sys_) -> dict:
    """B1 against its plain version on a system's finest operator at its
    current state, in the device plan its solve uses."""
    from femus_tpu_torch.algebra import bell

    a = sys_.assemblers[-1]
    u = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype, device=sys_.device)
    _, data = a.make_assemble_fn(pass_tables=True)(
        u, a.device_tables_cached(), sys_.aux_scalars, sys_._aux_arrays(-1))
    return b1_on_operator(bell.relayout_ell(sys_._bell_dev(a.pattern), data,
                                            device=sys_.device))


def half_cylinder(p):
    """The unit square onto the half cylinder of radius 1, height 1."""
    phi = np.pi * p[:, 0]
    return np.stack([np.cos(phi), np.sin(phi), p[:, 1]], axis=-1)


def surface_solve(n: int, dtype=torch.float64, tol=1e-10) -> dict:
    """Laplace-Beltrami -Lap_G u = (1 + pi^2) u on the half cylinder
    (tests/test_surface.py), u = sin(phi) sin(pi z) = y sin(pi z): one
    assembly through the manifold branch of the element geometry, then
    Jacobi-CG with its matvec on the BELL frame."""
    from femus_tpu_torch.algebra.bell import on_bell_frame
    from femus_tpu_torch.algebra.krylov import jacobi_cg
    from femus_tpu_torch.assembly.bc import generate_bdc
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.assembly.norms import error_norms, integrate_field
    from femus_tpu_torch.mesh.generation import map_to_surface, unit_box
    from femus_tpu_torch.systems.system import launch_counts

    pi = np.pi
    exact = lambda x: x[:, 1] * torch.sin(pi * x[:, 2])        # noqa: E731
    t0 = time.perf_counter()
    mesh = map_to_surface(unit_box((n, n)), half_cylinder)
    a = Assembler(mesh, [Unknown("u")], quad_order="seventh", dtype=dtype,
                  device="cuda")
    a.set_volume_form(poisson("u", rhs=lambda x: (1 + pi ** 2) * exact(x)))
    generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    assemble = a.make_assemble_fn()
    setup_s = time.perf_counter() - t0
    u0 = torch.zeros(a.n_dofs, dtype=dtype, device="cuda")
    assemble(u0)                                   # warm
    t0 = time.perf_counter()
    R, data = assemble(u0)
    torch.cuda.synchronize()
    asm_s = time.perf_counter() - t0
    routing = []
    A = on_bell_frame(a.op_with(data), a.pattern, "cuda", routing)
    n0 = launch_counts()["bell_spmv"]
    t0 = time.perf_counter()
    u, info = jacobi_cg(A, -R, tol=tol, maxiter=60000)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = launch_counts()["bell_spmv"] - n0
    one = torch.ones(a.n_dofs, dtype=dtype, device="cuda")
    return {"n": n, "n_dofs": a.n_dofs, "setup_s": setup_s,
            "assembly_s": asm_s, "solve_s": solve_s, "b1_launches": launches,
            "b1_held": b1_on_operator(A.bell) if hasattr(A, "bell")
            and A.bell.vals.is_cuda else None, "cg_iters": info.iters,
            "converged": info.converged, "residual": info.residual,
            "l2_error": error_norms(mesh, "biquadratic", u, exact,
                                    device="cuda")[0],
            "area": integrate_field(mesh, "biquadratic", one, device="cuda"),
            "routing": routing[0]}


def solves_on_b1(rows) -> bool:
    """Every solve launched B1 and B1 held against its plain version on
    the solve's operator."""
    return all(r["b1_launches"] > 0 and r["b1_held"]["ok"]
               and r["b1_held"]["repeats_bit_for_bit"] for r in rows)


def phase_surface() -> dict:
    """surface-cylinder-256 and the 128x128 mesh for the order."""
    rows = [surface_solve(SURF_N // 2), surface_solve(SURF_N)]
    order = float(np.log2(rows[0]["l2_error"] / rows[1]["l2_error"]))
    rep = {"phase": "surface", "rows": rows, "l2_order": order,
           "area_error": abs(rows[1]["area"] - np.pi)}
    emit(rep)
    if not all(r["converged"] for r in rows):
        raise AssertionError("surface: a CG solve missed its tolerance")
    if not (rep["area_error"] < 1e-9 and order > 2.5):
        raise AssertionError(f"surface: area or order: {rep}")
    if not solves_on_b1(rows):
        raise AssertionError("surface: no B1 launch, or B1 disagrees")
    return {"launches": sum(r["b1_launches"] for r in rows)}


def holomorphic_map(x):
    """The exact minimizer Dx = f(z) - z of f(z) = z + 0.1 z^2."""
    return 0.1 * (x[:, 0] ** 2 - x[:, 1] ** 2), 0.2 * x[:, 0] * x[:, 1]


def conformal_system(n: int, dtype=torch.float64):
    """conformal_minimization(("Dx1", "Dx2")) with normal=None on
    unit_box((n,n)) Q2 through the port's public entry points: Dirichlet
    data of the holomorphic map, started from it plus the bump
    +-0.03 sin(pi x) sin(pi y) (tests/test_conformal.py), Newton with
    Jacobi-GMRES(60) to rtol 1e-10 on the BELL frame (one level)."""
    from femus_tpu_torch.assembly.conformal import conformal_minimization
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import NonLinearImplicitSystem

    def bump(x):
        return 0.03 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    ml_mesh = MultiLevelMesh(unit_box((n, n), "quad"), 1)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("Dx1")
    ml_sol.add_solution("Dx2")
    ml_sol.initialize("Dx1", lambda x: holomorphic_map(x)[0] + bump(x))
    ml_sol.initialize("Dx2", lambda x: holomorphic_map(x)[1] - bump(x))
    ml_sol.attach_bc(lambda var, x, grp, t: (True, float(holomorphic_map(
        x[None])[0 if var == "Dx1" else 1][0])))
    ml_sol.generate_bdc()
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(NonLinearImplicitSystem, "Conformal")
    sys_.add_unknown("Dx1", "Dx2")
    sys_.set_assembly(conformal_minimization(("Dx1", "Dx2")))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.use_mg = False
    cfg.rtol = 1e-10
    cfg.restart = 60
    cfg.max_outer = 500
    cfg.max_nonlinear = 12
    cfg.nonlinear_tol = 1e-12
    sys_.init(device="cuda", dtype=dtype)
    return sys_, ml_mesh, ml_sol


def phase_conformal() -> dict:
    """conformal-128: the batch-first layout on the card.  Gates: at most
    12 Newton steps, every linear solve converged, Dx equal to the
    holomorphic map to 1e-9, conformal energy below 1e-10, B1 launched."""
    from femus_tpu_torch.assembly.conformal import conformal_energy
    from femus_tpu_torch.assembly.engine import ElemOps
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    sys_, ml_mesh, ml_sol = conformal_system(CONF_N)
    setup_s = time.perf_counter() - t0
    a = sys_.assemblers[-1]
    tables = a.device_tables_cached()
    assemble = a.make_assemble_fn(pass_tables=True)
    u0 = torch.as_tensor(sys_.gather(-1), device="cuda")
    assemble(u0, tables)                           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assemble(u0, tables)
    torch.cuda.synchronize()
    asm_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = sys_.history
    mesh = ml_mesh.finest()
    x = mesh.coords[mesh.dofmap("biquadratic").nodes]
    ex = holomorphic_map(x)
    err = max(float(np.abs(ml_sol.sol[-1]["Dx1"] - ex[0]).max()),
              float(np.abs(ml_sol.sol[-1]["Dx2"] - ex[1]).max()))
    conn = torch.as_tensor(mesh.dofmap("biquadratic").conn, device="cuda")
    d1, d2 = (torch.as_tensor(ml_sol.sol[-1][n], device="cuda")[conn]
              for n in ("Dx1", "Dx2"))
    energy = float(torch.func.vmap(lambda c, p, q: conformal_energy(
        ElemOps(tables["tabs"], tables["qweights"], c, a.dim),
        {"Dx1": p, "Dx2": q}))(tables["coords_e"], d1, d2).sum())
    rep = {"phase": "conformal", "n_dofs": a.n_dofs, "setup_s": setup_s,
           "batch_first_assembly_s": asm_s, "wall_s": wall,
           "newton_steps": len(hist),
           "gmres_iters": [h["lin_iters"] for h in hist],
           "step_seconds": [h["seconds"] for h in hist],
           "all_converged": all(h["converged"] for h in hist),
           "max_err_vs_holomorphic": err, "energy": energy,
           "b1_launches": launch_counts()["bell_spmv"],
           "routing": sys_.solver_info()["routing"]}
    rep["b1_held"] = b1_on_system(sys_)
    emit(rep)
    if not (len(hist) <= 12 and rep["all_converged"]
            and hist[-1]["eps"]["Dx1"] < 1e-10):
        raise AssertionError(f"conformal: Newton: {rep}")
    if not (err < 1e-9 and energy < 1e-10):
        raise AssertionError(f"conformal: off the holomorphic map: {rep}")
    if not solves_on_b1([rep]):
        raise AssertionError("conformal: no B1 launch, or B1 disagrees")
    return {"launches": rep["b1_launches"]}


def mixed_poisson(n: int, dtype=torch.float64, tol=1e-12) -> dict:
    """Q2 Poisson, exact sin(pi x) sin(pi y), on mixed_unit_box((n,n))
    (quads left of x = 1/2, triangles right) through MixedAssembler, then
    Jacobi-CG with its matvec on the BELL frame."""
    from femus_tpu_torch.algebra.bell import on_bell_frame
    from femus_tpu_torch.algebra.krylov import jacobi_cg
    from femus_tpu_torch.assembly.engine import Unknown
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.assembly.mixed import (MixedAssembler,
                                                generate_bdc_mixed)
    from femus_tpu_torch.assembly.norms import error_norms
    from femus_tpu_torch.mesh.mixed import mixed_unit_box
    from femus_tpu_torch.systems.system import launch_counts

    pi = np.pi
    exact = lambda x: torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])  # noqa
    t0 = time.perf_counter()
    masm = MixedAssembler(mixed_unit_box((n, n)), [Unknown("u")],
                          dtype=dtype, device="cuda")
    masm.set_volume_form(poisson("u", rhs=lambda x: 2 * pi ** 2 * exact(x)))
    generate_bdc_mixed(masm, lambda var, x, grp, t: (True, 0.0))
    R, data = masm.make_assemble_fn()(torch.zeros(masm.n_dofs, dtype=dtype,
                                                  device="cuda"))
    routing = []
    A = on_bell_frame(masm.op_with(data), masm.pattern, "cuda", routing)
    setup_s = time.perf_counter() - t0
    n0 = launch_counts()["bell_spmv"]
    t0 = time.perf_counter()
    u, info = jacobi_cg(A, -R, tol=tol, maxiter=60000)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = launch_counts()["bell_spmv"] - n0
    err = float(np.sqrt(sum(error_norms(s.mesh, "biquadratic", u, exact,
                                        device="cuda")[0] ** 2
                            for s in masm.subs)))
    return {"n": n, "n_dofs": masm.n_dofs, "blocks": masm.mesh.geoms,
            "elements": masm.mesh.n_elems, "setup_s": setup_s,
            "solve_s": solve_s, "b1_launches": launches,
            "b1_held": b1_on_operator(A.bell) if hasattr(A, "bell")
            and A.bell.vals.is_cuda else None, "cg_iters": info.iters,
            "converged": info.converged, "l2_error": err,
            "routing": routing[0]}


def phase_mixed() -> dict:
    """mixed-poisson-128 and the 64x64 mesh for the order."""
    rows = [mixed_poisson(MIXED_N // 2), mixed_poisson(MIXED_N)]
    order = float(np.log2(rows[0]["l2_error"] / rows[1]["l2_error"]))
    rep = {"phase": "mixed", "rows": rows, "l2_order": order}
    emit(rep)
    if not (all(r["converged"] for r in rows) and order > 2.5):
        raise AssertionError(f"mixed: convergence or order: {rep}")
    if not solves_on_b1(rows):
        raise AssertionError("mixed: no B1 launch, or B1 disagrees")
    return {"launches": sum(r["b1_launches"] for r in rows)}


def sw_system(kind: str, n: int, dtype=torch.float64):
    """sw-128 through the port's public entry points on unit_box((n,n)) Q2,
    Crank-Nicolson, dt SW_DT, operator="bell" with tests/test_sw.py's
    solver (no multigrid, Jacobi-GMRES): "lake" = (h, u, v) at rest over
    the bump b = 0.2 exp(-50 |x - c|^2) (an aux field), h + b = 1, walls
    u = v = 0; "tracer" = tracer_advection of a Gaussian blob in the
    uniform drift (0.5, 0) (aux fields), kappa 1e-4, c = 0 on the walls."""
    from femus_tpu_torch.assembly.sw import shallow_water, tracer_advection
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.transient import (
        TransientNonlinearImplicitSystem, crank_nicolson)

    ml_mesh = MultiLevelMesh(unit_box((n, n), "quad"), 1)
    ml_sol = MultiLevelSolution(ml_mesh)
    q2 = "biquadratic"
    if kind == "lake":
        def bump(x):
            return 0.2 * np.exp(-50 * ((x[:, 0] - 0.5) ** 2
                                       + (x[:, 1] - 0.5) ** 2))

        names, aux = ("h", "u", "v"), ("b",)
        for v in names:
            ml_sol.add_solution(v, q2, time_order=1)
        ml_sol.add_solution("b", q2)
        ml_sol.initialize("h", lambda x: 1.0 - bump(x))
        ml_sol.initialize("u")
        ml_sol.initialize("v")
        ml_sol.initialize("b", bump)
        ml_sol.attach_bc(lambda var, x, grp, t: (var in ("u", "v"), 0.0))
        base = shallow_water("h", ("u", "v"), q2, g=1.0,
                             bathymetry_field="b")
    else:
        names, aux = ("c",), ("u", "v")
        ml_sol.add_solution("c", q2, time_order=1)
        ml_sol.add_solution("u", q2)
        ml_sol.add_solution("v", q2)
        ml_sol.initialize("c", lambda x: np.exp(
            -60 * ((x[:, 0] - 0.35) ** 2 + (x[:, 1] - 0.5) ** 2)))
        ml_sol.initialize("u", lambda x: 0.5 + 0 * x[:, 0])
        ml_sol.initialize("v", lambda x: 0 * x[:, 0])
        ml_sol.attach_bc(lambda var, x, grp, t: (var == "c", 0.0))
        base = tracer_advection("c", ("u", "v"), q2, kappa=1e-4)
    ml_sol.generate_bdc(*names)
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(TransientNonlinearImplicitSystem, kind)
    sys_.add_unknown(*names)
    for a in aux:
        sys_.add_aux_field(a)
    sys_.set_assembly(crank_nicolson(base, {v: q2 for v in names}))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.outer = "gmres"
    cfg.use_mg = False
    if kind == "lake":
        cfg.rtol = 1e-12
        cfg.max_nonlinear = 6
    sys_.init_time(SW_DT)
    sys_.init(device="cuda", dtype=dtype)
    return sys_, ml_mesh, ml_sol


def phase_sw() -> dict:
    """sw-128: SW_LAKE_STEPS steps of the lake at rest (h, u, v stay still
    to 1e-8) and SW_TRACER_STEPS of the tracer (its centre of mass ends at
    (0.55 +- 0.04, 0.5 +- 0.02), tests/test_sw.py's gate)."""
    from femus_tpu_torch.systems.system import launch_counts

    rep, launches = {"phase": "sw"}, 0
    for kind, steps in (("lake", SW_LAKE_STEPS), ("tracer", SW_TRACER_STEPS)):
        t0 = time.perf_counter()
        sys_, ml_mesh, ml_sol = sw_system(kind, SW_N)
        setup_s = time.perf_counter() - t0
        start = {n: ml_sol.sol[-1][n].copy() for n in sys_.unknown_names}
        reset_launches()
        t0 = time.perf_counter()
        newton, gmres, ok = [], [], True
        for _ in range(steps):
            sys_.time_step()
            newton.append(len(sys_.history))
            gmres.append(sum(h["lin_iters"] for h in sys_.history))
            ok = ok and all(h["converged"] for h in sys_.history)
        torch.cuda.synchronize()
        row = {"n_dofs": sys_.assemblers[-1].n_dofs, "steps": steps,
               "setup_s": setup_s, "wall_s": time.perf_counter() - t0,
               "newton_steps": newton, "gmres_iters": gmres,
               "all_converged": ok,
               "b1_launches": launch_counts()["bell_spmv"]}
        row["b1_held"] = b1_on_system(sys_)
        launches += row["b1_launches"]
        if kind == "lake":
            row["max_dh"] = float(np.abs(ml_sol.sol[-1]["h"]
                                         - start["h"]).max())
            row["max_uv"] = max(float(np.abs(ml_sol.sol[-1][n]).max())
                                for n in ("u", "v"))
        else:
            mesh = ml_mesh.finest()
            xs = mesh.coords[mesh.dofmap("biquadratic").nodes]
            c = ml_sol.sol[-1]["c"]
            row["centre_of_mass"] = [float((xs[:, d] * c).sum() / c.sum())
                                     for d in (0, 1)]
        rep[kind] = row
        del sys_, ml_mesh, ml_sol
    emit(rep)
    lake, tr = rep["lake"], rep["tracer"]
    if not (lake["all_converged"] and tr["all_converged"]):
        raise AssertionError("sw: a linear solve missed its rtol")
    if not (lake["max_dh"] < 1e-8 and lake["max_uv"] < 1e-8):
        raise AssertionError(f"sw: the lake moved: {lake}")
    xc, yc = tr["centre_of_mass"]
    if not (abs(xc - 0.55) <= 0.04 and abs(yc - 0.5) <= 0.02):
        raise AssertionError(f"sw: tracer centre of mass {xc}, {yc}")
    if not solves_on_b1([lake, tr]):
        raise AssertionError("sw: no B1 launch, or B1 disagrees")
    return {"launches": launches}


def phase_nonlocal() -> dict:
    """nonlocal-64 on the card in float64: the pair assembly, the
    operator's symmetry and null space, B1 against its plain version on
    this operator (rows of up to 357 entries), and solve_dirichlet (CG on
    the BELL frame) with the core-shape gate of tests/test_nonlocal.py."""
    import scipy.sparse as sp
    from femus_tpu_torch.algebra.bell import bell_device_plan, on_bell_frame
    from femus_tpu_torch.assembly.nonlocal_diffusion import NonlocalOperator
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.systems.system import launch_counts

    pi = np.pi
    t0 = time.perf_counter()
    op = NonlocalOperator(unit_box((NONLOCAL_N, NONLOCAL_N), "quad"),
                          "linear", delta=NONLOCAL_DELTA, quad_order=3,
                          device="cuda", dtype=torch.float64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = op._assemble()
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    pat = op.pattern
    vals = data.cpu().numpy()
    A = sp.csr_matrix((vals[pat.valid], (np.nonzero(pat.valid)[0],
                                         pat.cols[pat.valid])),
                      shape=(pat.n_rows, pat.n_cols))
    amax = float(np.abs(vals).max())
    sym = float(abs(A - A.T).max())
    Ab = on_bell_frame(op.op(), pat, "cuda")
    ones = float((Ab @ torch.ones(pat.n_rows, dtype=torch.float64,
                                  device="cuda")).abs().max())
    dev, _ = bell_device_plan(pat, "identity", "cuda")
    k = b1_rows(data, pat, dev, "nonlocal_kernel", (("f64", torch.float64),))
    reset_launches()
    t0 = time.perf_counter()
    u, info = op.solve_dirichlet(
        lambda x: 2 * pi ** 2 * torch.sin(pi * x[:, 0])
        * torch.sin(pi * x[:, 1]), lambda x: np.zeros(len(x)))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    x = op.mesh.coords[op.dofmap.nodes]
    exact = np.sin(pi * x[:, 0]) * np.sin(pi * x[:, 1])
    core = ((x[:, 0] > 0.3) & (x[:, 0] < 0.7) & (x[:, 1] > 0.3)
            & (x[:, 1] < 0.7))
    ratio = u[core] / exact[core]
    rep = {"phase": "nonlocal", "n_dofs": pat.n_rows, "nnz": int(pat.nnz),
           "width": pat.width, "pairs": len(op.pairs), "setup_s": setup_s,
           "pair_assembly_s": pair_s, "solve_s": solve_s,
           "cg_iters": info.iters, "converged": info.converged,
           "symmetry": sym / amax, "a_one": ones / amax,
           "core_ratio_cv": float(ratio.std() / ratio.mean()),
           "routing": op.routing, "kernel_launches": launch_counts()}
    emit(rep)
    if not (rep["symmetry"] < 1e-10 and rep["a_one"] < 1e-8):
        raise AssertionError(f"nonlocal: symmetry or null space: {rep}")
    if not (info.converged and rep["core_ratio_cv"] < 0.15
            and np.isfinite(u).all()):
        raise AssertionError(f"nonlocal: solve: {rep}")
    if not (op.routing["path"] == "bell"
            and rep["kernel_launches"]["bell_spmv"] > 0):
        raise AssertionError("nonlocal: the solve ran no B1")
    return {**k, "launches": rep["kernel_launches"]["bell_spmv"]}


def run_slice8() -> dict:
    """The slice-8 phases in order; their reports by short name."""
    t0 = time.perf_counter()
    bsys, bsol = boussinesq_system(COARSE_CELLS, LEVELS, "cuda",
                                   torch.float32, rtol=1e-4,
                                   max_nonlinear=BOUS_NEWTON)
    setup_s = time.perf_counter() - t0
    emit({"phase": "bous_setup", "seconds": setup_s,
          "n_dofs": bsys.assemblers[-1].n_dofs,
          "levels": [a.n_dofs for a in bsys.assemblers]})
    out = {"kernel": phase_kernel(bsys, "bous_kernel")}
    out["main"] = phase_bous_main(bsys, bsol, setup_s)
    del bsys, bsol
    phase_bous_reference()
    out["forms"] = phase_forms()
    out["surface"] = phase_surface()
    out["conformal"] = phase_conformal()
    out["mixed"] = phase_mixed()
    out["sw"] = phase_sw()
    out["nonlocal"] = phase_nonlocal()
    return out


def write_neu(mesh, path: str, family: str = "biquadratic",
              boundary: bool = True) -> None:
    """Write a single-geometry mesh as a Gambit neutral file (the layout
    mesh/gambit.py reads): every element's ``family`` nodes (renumbered
    compactly) in Gambit's node order, one element group per
    ``elem_group`` label and, with ``boundary``, one boundary-condition
    set per boundary group."""
    from femus_tpu_torch.fe.geom import GEOMS
    from femus_tpu_torch.mesh.gambit import _GTYPE, _MY_FACE_FROM_GAMBIT, _PERMS

    local = GEOMS[mesh.geom].family_nodes[family]
    used, inv = np.unique(mesh.conn[:, local], return_inverse=True)
    conn = inv.reshape(mesh.n_elems, len(local)) + 1
    gconn = np.empty_like(conn)
    gconn[:, _PERMS[(mesh.geom, len(local))]] = conn
    gtype = {g: t for t, g in _GTYPE.items()}[mesh.geom]
    gface = np.argsort(_MY_FACE_FROM_GAMBIT[mesh.geom])     # ours -> Gambit
    sets = {}
    if boundary:
        for bf in mesh.boundary.values():
            for e, f, g in zip(bf.elem, bf.iface, bf.group):
                sets.setdefault(int(g), []).append((int(e), int(f)))
    labels = np.unique(mesh.elem_group)
    out = ["        CONTROL INFO 2.4.6", "** GAMBIT NEUTRAL FILE",
           "written by chip_smoke.write_neu", "PROGRAM:  Gambit  VERSION:  2.4.6",
           "", "     NUMNP     NELEM     NGRPS    NBSETS     NDFCD     NDFVL",
           f"{len(used):10d}{mesh.n_elems:10d}{len(labels):10d}"
           f"{len(sets):10d}{mesh.dim:10d}{mesh.dim:10d}", "ENDOFSECTION",
           "   NODAL COORDINATES 2.4.6"]
    out += [f"{k + 1:10d} " + " ".join(f"{v:.17e}" for v in xyz)
            for k, xyz in enumerate(mesh.coords[used])]
    out += ["ENDOFSECTION", "      ELEMENTS/CELLS 2.4.6"]
    for e, row in enumerate(gconn):
        out.append(f"{e + 1:8d} {gtype:2d} {len(row):2d} "
                   + " ".join(str(v) for v in row[:7]))
        out += [" " * 15 + " ".join(str(v) for v in row[k:k + 7])
                for k in range(7, len(row), 7)]
    out.append("ENDOFSECTION")
    for gi, lab in enumerate(labels):
        ids = np.nonzero(mesh.elem_group == lab)[0] + 1
        out += ["       ELEMENT GROUP 2.4.6",
                f"GROUP: {gi + 1:10d} ELEMENTS: {len(ids):10d} MATERIAL: "
                f"{2:10d} NFLAGS: {1:10d}", f"{int(lab):32d}", "       0"]
        out += [" ".join(f"{v:7d}" for v in ids[k:k + 10])
                for k in range(0, len(ids), 10)]
        out.append("ENDOFSECTION")
    for g, faces in sorted(sets.items()):
        out += [" BOUNDARY CONDITIONS 2.4.6",
                f"{g:>32d}{1:8d}{len(faces):8d}{0:8d}{6:8d}"]
        out += [f"{e + 1:10d}{gtype:5d}{gface[f] + 1:5d}" for e, f in faces]
        out.append("ENDOFSECTION")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def _submesh(m0, keep, group_fn):
    """The elements ``keep`` of the box mesh ``m0`` (nodes renumbered
    compactly) with boundary faces labelled by ``group_fn``."""
    from femus_tpu_torch.mesh.mesh import Mesh, build_boundary_faces

    used = np.unique(m0.conn[keep])
    remap = -np.ones(m0.coords.shape[0], np.int64)
    remap[used] = np.arange(len(used))
    m = Mesh(dim=2, geom="quad", coords=m0.coords[used],
             conn=remap[m0.conn[keep]].astype(np.int32),
             elem_group=m0.elem_group[keep])
    build_boundary_faces(m, group_fn=group_fn)
    return m


def channel_neu(path: str, nx: int, ny: int, solid: bool = False) -> str:
    """Write a Turek-style channel as a Gambit file at ``path`` (the mesh
    the ported apps read in place of the absent nsbenc.neu and
    fsifirst.neu; not the benchmark geometry): box((nx, ny)) on (0, 2.2) x
    (0, 0.41) without the cells whose centroids lie within 0.06 of (0.2,
    0.2) in the max norm (at 44 x 8 a square obstacle of 2 x 2 cells, 0.1 x
    0.1025, where Turek has a cylinder of radius 0.05); boundary groups 1
    inflow x = 0, 2 outflow x = 2.2, 3 the walls y = 0 and y = 0.41, 4 the
    obstacle (the groups the apps' conditions read).  ``solid``: the cells
    of the obstacle's lower cell row with centroid x in (0.25, 0.6) get
    element group 5 (fsi_bench.SOLID_GROUP), a beam 0.35 long and one
    coarse cell thick (Turek's is 0.02 thick).  Returns ``path``."""
    from femus_tpu_torch.mesh.generation import box

    m0 = box((nx, ny), [(0.0, 2.2), (0.0, 0.41)], "quad")
    cent = m0.coords[m0.conn[:, :4]].mean(axis=1)
    hole = np.abs(cent - 0.2).max(axis=1) < 0.06
    if solid:
        row = cent[:, 1] == cent[hole, 1].min()
        beam = row & ~hole & (cent[:, 0] > 0.25) & (cent[:, 0] < 0.6)
        m0.elem_group = np.where(beam, 5, m0.elem_group).astype(np.int32)

    def group(c):
        if c[0] < 1e-9:
            return 1
        if c[0] > 2.2 - 1e-9:
            return 2
        if c[1] < 1e-9 or c[1] > 0.41 - 1e-9:
            return 3
        return 4

    write_neu(_submesh(m0, ~hole, group), path)
    return path


def disk_neu(path: str, n: int) -> str:
    """Write the unit disk as a Gambit file at ``path`` (ex08's mesh in
    place of the absent disk.neu): box((n, n)) on (-1, 1)^2, every node
    mapped by (x sqrt(1 - y^2/2), y sqrt(1 - x^2/2)), one boundary group.
    Returns ``path``."""
    from femus_tpu_torch.mesh.generation import box

    m0 = box((n, n), [(-1.0, 1.0), (-1.0, 1.0)], "quad")
    x, y = m0.coords[:, 0].copy(), m0.coords[:, 1].copy()
    m0.coords = np.stack([x * np.sqrt(1 - y * y / 2),
                          y * np.sqrt(1 - x * x / 2)], axis=1)
    write_neu(_submesh(m0, np.ones(m0.n_elems, bool), lambda c: 1), path)
    return path


def read_groups_bc(var, x, grp, t):
    """Homogeneous Dirichlet on the boundary groups read from the file."""
    return grp in NEU_GROUPS, 0.0


def phase_gambit() -> dict:
    """gambit-poisson-256: FEMuS's ReadCoarseMesh -> refine flow.  A
    unit_box((32,32)) Q2 mesh is written as a Gambit .neu file with four
    boundary groups, read back with read_neu, refined to NEU_LEVELS levels
    (finest 256x256, 263,169 dofs), and Q2 Poisson with the sin sin
    solution is solved on every depth (convergence_study; MG-CG on the
    BELL operator to 1e-12, float64) with its Dirichlet conditions on the
    read groups; B1 on the finest operator against its plain version."""
    from femus_tpu_torch.mesh.gambit import read_neu
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.systems.fe_convergence import convergence_study
    from femus_tpu_torch.systems.system import launch_counts

    pi = np.pi
    coarse = unit_box((NEU_COARSE, NEU_COARSE))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "box32_quad9.neu")
        t0 = time.perf_counter()
        write_neu(coarse, path)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        write_s = t1 - t0
        mesh = read_neu(path)
        read_s = time.perf_counter() - t1
    same = (np.array_equal(mesh.coords, coarse.coords)
            and np.array_equal(mesh.conn, coarse.conn)
            and np.array_equal(mesh.elem_group, coarse.elem_group)
            and sorted(mesh.boundary) == sorted(coarse.boundary)
            and all(np.array_equal(getattr(mesh.boundary[fg], f),
                                   getattr(coarse.boundary[fg], f))
                    for fg in coarse.boundary
                    for f in ("elem", "iface", "group", "conn")))
    groups = sorted({int(g) for bf in mesh.boundary.values()
                     for g in bf.group})
    solves = []
    reset_launches()
    t0 = time.perf_counter()
    res = convergence_study(
        poisson_q2_solver("cuda", torch.float64, bc=read_groups_bc,
                          solves=solves),
        mesh, NEU_LEVELS,
        {"u": lambda x: torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])},
        {"u": lambda x: pi * torch.stack(
            [torch.cos(pi * x[:, 0]) * torch.sin(pi * x[:, 1]),
             torch.sin(pi * x[:, 0]) * torch.cos(pi * x[:, 1])], dim=-1)},
        device="cuda")
    torch.cuda.synchronize()
    rep = {"phase": "gambit", "file_bytes": size,
           "write_s": write_s,
           "read_s": read_s, "read_equals_generated": same,
           "groups": groups, "seconds": time.perf_counter() - t0,
           "n_dofs": [s["n_dofs"] for s in solves],
           "cg_iters": [s["iters"] for s in solves],
           "solve_s": [s["solve_s"] for s in solves],
           "converged": [s["converged"] for s in solves],
           "l2_errors": res.l2_errors["u"], "l2_orders": res.l2_orders["u"],
           "h1_orders": res.h1_orders["u"],
           "kernel_launches": launch_counts()}
    emit(rep)
    if not (same and groups == list(NEU_GROUPS)):
        raise AssertionError("gambit: the read mesh differs from the "
                             "written one")
    if not (all(rep["converged"]) and rep["l2_orders"][-1] > 2.7):
        raise AssertionError(f"gambit: solve or order\n{res.report()}")
    if rep["kernel_launches"]["bell_spmv"] <= 0:
        raise AssertionError("gambit: no B1 launch")
    k = phase_kernel(solves[-1]["system"], "gambit_kernel",
                     (("f64", torch.float64),))
    return {**k, "launches": rep["kernel_launches"]["bell_spmv"]}


def disk_markers(n: int, seed: int = 0) -> np.ndarray:
    """``n`` points uniform in the disk of radius 0.4 about (0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    r = 0.4 * np.sqrt(rng.uniform(size=n))
    th = 2 * np.pi * rng.uniform(size=n)
    return 0.5 + np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


def rotation_field(mesh):
    """The Q2 rigid rotation u = -(y - 1/2), v = x - 1/2 (period 2 pi)."""
    xy = mesh.coords[mesh.dofmap("biquadratic").nodes]
    return -(xy[:, 1] - 0.5), xy[:, 0] - 0.5


def phase_markers() -> dict:
    """markers-256: 2^20 markers in a disk on unit_box((256,256)): locate
    on the card (host nearest-centroid guess, float64 walk), then RK4
    advection through the Q2 rigid rotation, MARKERS_TURN of a revolution
    at MARKERS_STEPS steps a revolution (FEMuS ISM Line::AdvectionParallel),
    held to the exact rotated start; a 4,096-marker subset located and
    advected on the host too; then ex05's magnetic capture on
    MAGNETIC_COUNT markers, MAGNETIC_STEPS steps."""
    from femus_tpu_torch.examples.ex05_markers_magnetic import (
        WIRE, capture_force)
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.particles.markers import (MarkerCloud, advect,
                                                   locate, make_advect_fn)

    mesh = unit_box((MARKERS_N, MARKERS_N))
    pts = disk_markers(MARKERS_COUNT)
    cloud = MarkerCloud(mesh, pts.copy(), np.zeros(len(pts), np.int64))
    t0 = time.perf_counter()
    locate(cloud, device="cuda")
    locate_s = time.perf_counter() - t0
    sub = MarkerCloud(mesh, pts[:MARKERS_SUBSET].copy(),
                      np.zeros(MARKERS_SUBSET, np.int64))
    locate(sub, device="cpu")
    owners_equal = bool(np.array_equal(sub.elem, cloud.elem[:MARKERS_SUBSET]))
    u, v = rotation_field(mesh)
    f64 = dict(dtype=torch.float64, device="cuda")
    step = make_advect_fn(mesh, ["biquadratic"] * 2, order=4, **f64)
    vd = (torch.as_tensor(u, **f64), torch.as_tensor(v, **f64))
    x = torch.as_tensor(cloud.x, **f64)
    e = torch.as_tensor(cloud.elem, device="cuda")
    dt = 2 * np.pi / MARKERS_STEPS
    x, e = step(x, e, vd, dt)                     # warm
    x = torch.as_tensor(cloud.x, **f64)
    e = torch.as_tensor(cloud.elem, device="cuda")
    steps = round(MARKERS_TURN * MARKERS_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        x, e = step(x, e, vd, dt)
    torch.cuda.synchronize()
    adv_s = time.perf_counter() - t0
    # the exact end: the start rotated by 2 pi MARKERS_TURN about the centre
    c, s_ = np.cos(2 * np.pi * MARKERS_TURN), np.sin(2 * np.pi * MARKERS_TURN)
    end = 0.5 + (pts - 0.5) @ np.array([[c, s_], [-s_, c]])
    ret = float((x - torch.as_tensor(end, **f64)).abs().max())
    located = int((e >= 0).sum())
    # the subset, 1/20 revolution, card against host
    cs = [MarkerCloud(mesh, sub.x.copy(), sub.elem.copy()) for _ in "ch"]
    for c, dev in zip(cs, ("cuda", "cpu")):
        advect(c, [u, v], ["biquadratic"] * 2, 2 * np.pi / 20,
               MARKERS_STEPS // 20, order=4, dtype=torch.float64, device=dev)
    sub_err = float(np.abs(cs[0].x - cs[1].x).max())
    sub_owners = bool(np.array_equal(cs[0].elem, cs[1].elem))
    # ex05: a wire at (0.95, 0.5) along z, slow rotation, capped drift
    wire = WIRE
    rng = np.random.default_rng(1)
    mp = 0.5 + rng.uniform(-0.25, 0.25, size=(MAGNETIC_COUNT, 2))
    mc = MarkerCloud(mesh, mp.copy(), np.zeros(MAGNETIC_COUNT, np.int64))
    locate(mc, device="cuda")
    d0 = float(np.linalg.norm(mc.x - wire, axis=1).mean())
    t0 = time.perf_counter()
    advect(mc, [0.2 * u, 0.2 * v], ["biquadratic"] * 2,
           0.02 * MAGNETIC_STEPS, MAGNETIC_STEPS, order=4,
           force_fn=capture_force(), dtype=torch.float64, device="cuda")
    mag_s = time.perf_counter() - t0
    dist = np.linalg.norm(mc.x - wire, axis=1)
    rep = {"phase": "markers", "markers": MARKERS_COUNT,
           "elements": mesh.n_elems, "locate_s": locate_s,
           "located": int((cloud.elem >= 0).sum()),
           "owners_equal_host_subset": owners_equal,
           "steps": steps, "turn": MARKERS_TURN, "advect_s": adv_s,
           "s_per_step": adv_s / steps,
           "marker_steps_per_s": MARKERS_COUNT * steps / adv_s,
           "located_after": located, "return_error": ret,
           "subset_card_host_max_diff": sub_err,
           "subset_owners_equal": sub_owners,
           "magnetic": {"markers": MAGNETIC_COUNT, "seconds": mag_s,
                        "mean_dist_before": d0,
                        "mean_dist_after": float(dist.mean()),
                        "within_0.15": int((dist < 0.15).sum()),
                        "in_domain": int((mc.elem >= 0).sum())}}
    emit(rep)
    if not (rep["located"] == MARKERS_COUNT == located and owners_equal):
        raise AssertionError(f"markers: location: {rep}")
    if not (ret <= 1e-6 and sub_err <= 1e-12 and sub_owners):
        raise AssertionError(f"markers: advection: {rep}")
    if not rep["magnetic"]["mean_dist_after"] < d0:
        raise AssertionError(f"markers: no magnetic capture: {rep}")
    return rep


def mpm_block(n: int, device):
    """The elastic block of tests/test_mpm.py on unit_box((n, n)): a block
    of 0.3 of the side (rounded to whole cells) centred in x, its bottom
    one cell above the floor, neo-Hookean(50, 50), density 1, ppc = 4, the
    floor's grid dofs fixed, gravity -1, FLIP 0.9, float64.  Returns
    (mesh, state, step)."""
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.particles.mpm import (init_particles, make_mpm_step,
                                               neo_hookean_stress)

    h, w = 1.0 / n, max(1, round(0.3 * n))
    x0, y0 = (n - w) // 2 * h, h
    mesh = unit_box((n, n))
    s = init_particles(mesh, lambda x: ((x[:, 0] > x0) & (x[:, 0] < x0 + w * h)
                                        & (x[:, 1] > y0)
                                        & (x[:, 1] < y0 + w * h)),
                       ppc=4, density=1.0, device=device, dtype=torch.float64)
    fixed = mesh.coords[mesh.dofmap("linear").nodes][:, 1] < 1e-9
    step = make_mpm_step(mesh, neo_hookean_stress(50.0, 50.0),
                         gravity=(0.0, MPM_G), flip=0.9, fixed_dofs=fixed,
                         device=device, dtype=torch.float64)
    return mesh, s, step


def phase_mpm() -> dict:
    """mpm-block-128: MPM_STEPS explicit steps of the block at 128x128
    (about 23,000 particles) on the card, and the block at 8x8 on the card
    and the host."""
    from femus_tpu_torch.particles.mpm import grid_fields

    mesh, s, step = mpm_block(MPM_N, "cuda")
    M = float(s.mass.sum())
    mi, _ = grid_fields(mesh, s)
    # before contact (the lowest particle reaches y = h, where the floor's
    # fixed dofs enter its element) the block falls freely
    gap = float(s.x[:, 1].min()) - 1.0 / MPM_N
    t_contact = np.sqrt(2 * gap / abs(MPM_G))
    p, yc, jmin, jmax, ymin = [], [], 1.0, 1.0, 1.0
    t0 = time.perf_counter()
    for _ in range(MPM_STEPS):
        s = step(s, MPM_DT)
        J = torch.linalg.det(s.F)
        row = torch.stack([(s.mass * s.v[:, 1]).sum() / M,
                           (s.mass * s.x[:, 1]).sum() / M, J.min(), J.max(),
                           s.x[:, 1].min()]).tolist()
        p.append(row[0])
        yc.append(row[1])
        jmin, jmax = min(jmin, row[2]), max(jmax, row[3])
        ymin = min(ymin, row[4])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t = MPM_DT * np.arange(1, MPM_STEPS + 1)
    free = t < t_contact
    ff_err = float(np.abs(np.array(p)[free] - MPM_G * t[free]).max()
                   / abs(MPM_G * t[free][-1]))
    k0 = int(free.sum())
    v_hit = abs(p[k0 - 1])
    after = np.array(p[k0:])
    drift = float(np.abs(np.array(yc[k0:]) - yc[k0 - 1]).max())
    rep = {"phase": "mpm", "particles": int(s.x.shape[0]),
           "grid_dofs": mesh.dofmap("linear").n_dofs, "steps": MPM_STEPS,
           "dt": MPM_DT, "seconds": wall, "s_per_step": wall / MPM_STEPS,
           "p2g_mass_rel_err": abs(float(mi.sum()) - M) / M,
           "free_fall_steps": k0, "free_fall_rel_err": ff_err,
           "impact_speed": v_hit, "vcom_after_min": float(after.min()),
           "vcom_after_max": float(after.max()),
           "vcom_last": p[-1], "com_drift_after_contact": drift,
           "detF_min": jmin, "detF_max": jmax, "y_min": ymin,
           "in_domain": int((s.elem >= 0).sum())}
    # the same block at 8x8: card against host in float64 (the card's
    # atomics add the P2G sums in another order)
    out = []
    for dev in ("cuda", "cpu"):
        _, s8, step8 = mpm_block(8, dev)
        for _ in range(MPM_REF_STEPS):
            s8 = step8(s8, MPM_DT * MPM_N / 8)
        out.append(s8)
    rep["reference"] = {f: float((getattr(out[0], f).cpu()
                                  - getattr(out[1], f)).abs().max()
                                 / getattr(out[1], f).abs().max())
                        for f in ("x", "v", "F")}
    rep["reference"]["elem_equal"] = bool(torch.equal(out[0].elem.cpu(),
                                                      out[1].elem))
    emit(rep)
    if not rep["p2g_mass_rel_err"] <= 1e-13:
        raise AssertionError(f"mpm: P2G mass: {rep}")
    if not (k0 >= 10 and ff_err <= 1e-10):
        raise AssertionError(f"mpm: free fall: {rep}")
    # the floor stops the fall: the centre of mass turns back up, never
    # faster than it hit, and stays within half a cell of its height at
    # contact; no particle leaves the mesh or goes below the floor
    if not (after.max() > 0 and np.abs(after).max() <= 1.05 * v_hit
            and drift <= 0.5 / MPM_N and ymin > 0
            and rep["in_domain"] == rep["particles"]):
        raise AssertionError(f"mpm: the block does not come to rest on the "
                             f"floor: {rep}")
    if not 0.5 < jmin <= jmax < 2.0:
        raise AssertionError(f"mpm: det F: {rep}")
    if not (max(rep["reference"][f] for f in ("x", "v", "F")) <= MPM_REF_TOL
            and rep["reference"]["elem_equal"]):
        raise AssertionError(f"mpm: card and host differ: {rep}")
    return rep


def mpm_fsi_case(n: int, device):
    """ex06 (tests/test_mpm_fsi.py's sinking block) on unit_box((n, n))
    through the example's own builder, MPM_FSI_NEWTON Newton iterations a
    step.  Returns (fsi, state, u)."""
    from femus_tpu_torch.examples.ex06_mpm_fsi_block import build
    return build(n, device, newton_iters=MPM_FSI_NEWTON)


def phase_mpm_fsi() -> dict:
    """mpm-fsi-sinking-64: MPM_FSI_STEPS implicit steps of ex06 at n = 64
    (37,507 dofs): assembly with the particle form, P2G and G2P on the
    card, each Newton correction by scipy spsolve on the host; then n = 6
    on the card and the host."""
    t0 = time.perf_counter()
    fsi, s, u = mpm_fsi_case(MPM_FSI_N, "cuda")
    setup_s = time.perf_counter() - t0
    com = [float(s.x[:, 1].mean())]
    t0 = time.perf_counter()
    for _ in range(MPM_FSI_STEPS):
        s, u = fsi.step(s, u)
        com.append(float(s.x[:, 1].mean()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    J = torch.linalg.det(s.F)
    hist = fsi.history
    rep = {"phase": "mpm_fsi", "n_dofs": fsi.asm.n_dofs,
           "particles": int(s.x.shape[0]), "setup_s": setup_s,
           "seconds": wall, "steps": MPM_FSI_STEPS,
           "newton_its": [h["newton_its"] for h in hist],
           "res_norms": [h["res_norms"] for h in hist],
           "converged": [h["converged"] for h in hist],
           "assembly_s": [h["assembly_s"] for h in hist],
           "spsolve_s": [h["solve_s"] for h in hist],
           "com_y": com, "detF_min": float(J.min()),
           "detF_max": float(J.max()),
           "max_grid_speed": float(u.abs().max()),
           "in_domain": int((s.elem >= 0).sum())}
    out = []
    for dev in ("cuda", "cpu"):
        f6, s6, u6 = mpm_fsi_case(6, dev)
        for _ in range(2):
            s6, u6 = f6.step(s6, u6)
        out.append((s6, u6))
    rep["reference"] = {f: float((getattr(out[0][0], f).cpu()
                                  - getattr(out[1][0], f)).abs().max()
                                 / getattr(out[1][0], f).abs().max())
                        for f in ("x", "v", "F")}
    rep["reference"]["u"] = float((out[0][1].cpu() - out[1][1]).abs().max()
                                  / out[1][1].abs().max())
    emit(rep)
    if not all(rep["converged"]):
        raise AssertionError(f"mpm_fsi: Newton missed newton_tol: {rep}")
    if not (all(b < a for a, b in zip(com, com[1:]))
            and 0.8 < rep["detF_min"] <= rep["detF_max"] < 1.2
            and rep["in_domain"] == rep["particles"]):
        raise AssertionError(f"mpm_fsi: the block does not sink: {rep}")
    if not max(rep["reference"].values()) <= 1e-8:
        raise AssertionError(f"mpm_fsi: card and host differ: {rep}")
    return rep


def phase_projection() -> dict:
    """projection-256: projection_matrix from unit_box((256,256)) Q2 onto
    unit_box((200,200)) Q2 shifted by PROJ_SHIFT (160,801 destination
    dofs), point location and basis evaluation on the card; exact on a
    quadratic, the rows of points outside the source empty."""
    from femus_tpu_torch.mesh.generation import box, unit_box
    from femus_tpu_torch.mesh.projection import projection_matrix

    src = unit_box((PROJ_SRC, PROJ_SRC))
    dst = box((PROJ_DST, PROJ_DST), [(PROJ_SHIFT[0], 1 + PROJ_SHIFT[0]),
                                     (PROJ_SHIFT[1], 1 + PROJ_SHIFT[1])])
    t0 = time.perf_counter()
    M = projection_matrix(src, "biquadratic", dst, device="cuda")
    wall = time.perf_counter() - t0

    def quad(x):
        return 1.0 + 2 * x[:, 0] - x[:, 1] + 3 * x[:, 0] * x[:, 1] \
            - x[:, 1] ** 2

    xs = src.node_coords_of("biquadratic")
    xd = dst.node_coords_of("biquadratic")
    eps = 1e-9
    inside = ((xd >= -eps) & (xd <= 1 + eps)).all(axis=1)
    got = M @ quad(xs)
    rows = np.diff(M.indptr)
    rep = {"phase": "projection", "src_dofs": M.shape[1],
           "dst_dofs": M.shape[0], "nnz": int(M.nnz), "seconds": wall,
           "outside_points": int((~inside).sum()),
           "max_err_inside": float(np.abs(got[inside]
                                          - quad(xd[inside])).max()),
           "outside_rows_nonempty": int((rows[~inside] > 0).sum()),
           "inside_rows_empty": int((rows[inside] == 0).sum())}
    emit(rep)
    if not (rep["max_err_inside"] <= 1e-10 and rep["outside_points"] > 0
            and rep["outside_rows_nonempty"] == 0
            and rep["inside_rows_empty"] == 0):
        raise AssertionError(f"projection: {rep}")
    return rep


def phase_uq() -> dict:
    """uq-pce-128: (a) ex07's collocation at 128x128 Q2: one Jacobi-CG solve
    on B1 per Hermite node (nq_1d = UQ_NQ), PCE coefficients of u at the
    centre against the closed form c_k = u0 (-1)^k e^(1/2) / sqrt(k!),
    whose quadrature error at UQ_NQ nodes is computed here on the host;
    (b) the tables at 4 dimensions, total degree 6 (210 terms) on the
    card; (c) fit_pdf of UQ_SAMPLES card-drawn 2-D Gaussian samples at
    levels 5, 6 and 7 (769 basis functions)."""
    import math

    from femus_tpu_torch.algebra.bell import bell_device_plan
    from femus_tpu_torch.systems.system import launch_counts
    from femus_tpu_torch.uq import pce
    from femus_tpu_torch.uq.sparse_grid import avg_l2_error, fit_pdf

    from femus_tpu_torch.examples.ex07_uq_pce import poisson_solver

    t0 = time.perf_counter()
    solve, data1, pat = poisson_solver(UQ_N, "cuda", bell=True,
                                       maxiter=20000)
    setup_s = time.perf_counter() - t0
    idx = pce.total_degree_set(1, UQ_DEG)
    infos = []

    def fn(pts):
        out = []
        for xi in pts[:, 0].tolist():
            val, info = solve(math.exp(xi))
            out.append(val)
            infos.append(info)
        return torch.tensor(out, dtype=torch.float64)

    reset_launches()
    t0 = time.perf_counter()
    c = pce.pce_project("hermite", idx, fn, UQ_NQ, device="cuda").cpu().numpy()
    torch.cuda.synchronize()
    colloc_s = time.perf_counter() - t0
    launches = launch_counts()["bell_spmv"]
    u0, _ = solve(1.0)
    ks = np.arange(UQ_DEG + 1)
    fact = np.array([math.factorial(k) for k in ks], float)
    closed = (-1.0) ** ks * np.exp(0.5) / np.sqrt(fact)
    # the quadrature's own error on e^(-xi), host numpy (no PDE)
    x, w = pce.quadrature_1d("hermite", UQ_NQ)
    P = np.stack([pce.polys_1d("hermite", UQ_DEG, x, "cpu").numpy()[k]
                  for k in ks])
    quad_err = np.abs(P @ (w * np.exp(-x)) - closed)
    err = np.abs(c - u0 * closed)
    tol = (quad_err + 1e-9) * abs(u0)
    # (b) the tables
    t0 = time.perf_counter()
    iset = pce.total_degree_set(4, 6)
    G = pce.stochastic_mass_matrix("hermite", iset, 7, device="cuda")
    C = pce.triple_product_tensor("hermite", iset, 10, device="cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    eye = torch.eye(len(iset), dtype=torch.float64, device="cuda")
    cmax = float(C.abs().max())
    # (c) the sparse grid
    gen = torch.Generator(device="cuda").manual_seed(0)
    samples = torch.randn(UQ_SAMPLES, 2, generator=gen, device="cuda",
                          dtype=torch.float64)
    true = lambda x: np.exp(-(x ** 2).sum(1) / 2) / (2 * np.pi)   # noqa: E731
    sg = []
    for lvl in UQ_SG_LEVELS:
        t1 = time.perf_counter()
        pdf = fit_pdf(samples, lvl, bounds=np.array([[-4.0, 4.0]] * 2),
                      device="cuda")
        torch.cuda.synchronize()
        sg.append({"level": lvl, "basis": len(pdf.levels),
                   "fit_s": time.perf_counter() - t1,
                   "avg_l2_error": avg_l2_error(pdf, true)})
    rep = {"phase": "uq", "n_dofs": pat.n_rows, "setup_s": setup_s,
           "collocation_s": colloc_s, "nodes": UQ_NQ,
           "cg_iters": [i.iters for i in infos],
           "converged": all(i.converged for i in infos),
           "u0": u0, "coeffs": c.tolist(),
           "coeff_err": err.tolist(), "coeff_tol": tol.tolist(),
           "kernel_launches": launch_counts(),
           "tables_terms": len(iset), "tables_s": tables_s,
           "mass_minus_identity": float((G - eye).abs().max()),
           "triple_asym": max(float((C - C.transpose(0, 1)).abs().max()),
                              float((C - C.transpose(0, 2)).abs().max())
                              ) / cmax,
           "sparse_grid": sg}
    emit(rep)
    if not (rep["converged"] and (err <= tol).all()):
        raise AssertionError(f"uq: collocation: {rep}")
    if not (rep["mass_minus_identity"] <= 1e-12
            and rep["triple_asym"] <= 1e-12):
        raise AssertionError(f"uq: tables: {rep}")
    if not sg[-1]["avg_l2_error"] < sg[0]["avg_l2_error"]:
        raise AssertionError(f"uq: sparse-grid error does not fall: {rep}")
    if launches <= 0:
        raise AssertionError("uq: the collocation ran no B1")
    dev, _ = bell_device_plan(pat, "identity", "cuda")
    k = b1_rows(data1, pat, dev, "uq_kernel", (("f64", torch.float64),))
    return {**k, "launches": launches}


def run_slice9() -> dict:
    """The slice-9 phases in order; their reports by short name (each
    path's B1 launches counted from 0 around it)."""
    return {"gambit": phase_gambit(), "markers": phase_markers(),
            "mpm": phase_mpm(), "mpm_fsi": phase_mpm_fsi(),
            "projection": phase_projection(), "uq": phase_uq()}


# slice 10: the multi-device layer on one card.  DIST_RANKS processes share
# the card over gloo (NCCL refuses two ranks on one device); every rank runs
# kernel B1 (halo SpMV, sharded step) or B2 (sharded patch matvec) on its
# own block.  dist_partition: the gambit-poisson-256 mesh (unit_box((32,32))
# refined to 256x256, Q2, 263,169 dofs) cut 4 ways; dist_halo: the
# cavity-128 Navier-Stokes Jacobian (181,250 rows) in float32 and float64
# and the gambit-poisson-256 operator in float64, B1 per rank through
# all_to_all (overlapped and not) and the ELL gather;
# dist_step: Q2 Poisson at 256x256 with a DIST_STEP_LEVELS-level Galerkin
# V-cycle, outer CG to 1e-8 in float64 (the JAX package's
# tests/test_distributed.py step at full size), and the two-level cavity
# step of dryrun_multichip at cavity-64 (DIST_DRYRUN_COARSE coarse cells);
# dist_patch: poisson-patch-1M's operator over 4 slabs; dist_markers:
# markers-256's 2^20 markers for DIST_MARKERS_STEPS RK4 steps;
# nccl_world1: the halo SpMV and the sharded step at world size 1 on NCCL
# (no multi-card test: one rank, one card)
# DIST_REPS: timing repetitions of each rank's exchange and products
DIST_RANKS, DIST_REPS = 4, 10
# seconds a launch of ranks may take (set-up included) before it fails
DIST_TIMEOUT = 420
DIST_HALO_CASES = (("cavity", 128, "f32"), ("cavity", 128, "f64"),
                   ("poisson", 256, "f64"))
DIST_VARIANTS = (("bell", "auto", True), ("bell", "all_to_all", False),
                 ("ell", "auto", True))
DIST_STEP_LEVELS, DIST_DRYRUN_COARSE = 4, 32
# (RK4 steps of 2 pi / 400: a fortieth of a revolution, a cut in depth for
# the run's clock)
DIST_MARKERS_STEPS, DIST_MARKERS_DT = 10, 2 * np.pi / 400
# patch3d: Q2 Poisson, -Lap u = 3 pi^2 sin sin sin, operator="patch" on
# PatchedMultiLevelMesh(unit_box((6,6,6), "hex"), PATCH3D_LEVELS): finest
# 48^3 elements, 97^3 = 912,673 dofs, float32
PATCH3D_COARSE, PATCH3D_LEVELS = 6, 4
# the level (24^3 elements, 117,649 dofs) whose patch operator is held
# against B1 on the ELL operator of the same matrix
PATCH3D_ELL_LEVEL = 2


def _dist_step_configs() -> list:
    """(name, config, tolerance of 4 ranks against 1) of each dist_step
    case.  Slice 11 adds dryrun-vanka (the dryrun cavity with Vanka blocks
    of 2 elements on both levels, GMRES) and fsi-vanka-aux (one Newton
    step of the transient fsi-bed's first theta-step at fsi-bed-64's size,
    FSI_COARSE and FSI_LEVELS, float64: the R·A·P transfers, Vanka on
    every level, the K-cycle with FGMRES(15) for one cycle, the old
    fields as aux fields, after the ratchet of the coarser levels)."""
    dryrun = dict(case="dryrun", n=DIST_DRYRUN_COARSE, outer="gmres",
                  rtol=1e-6, restart=20, max_outer=3, local_format="bell")
    return [("poisson", dict(case="poisson",
                             n=NEU_COARSE << (NEU_LEVELS - 1),
                             levels=DIST_STEP_LEVELS, outer="cg", rtol=1e-8,
                             restart=30, max_outer=20, local_format="bell",
                             timed=True), 1e-9),
            ("dryrun", dict(dryrun, timed=True), 1e-8),
            # one GMRES(20) cycle: the solve stagnates from the first cycle
            # on (ROADMAP C)
            ("dryrun-vanka", dict(dryrun, smoother="vanka", max_outer=1),
             1e-9),
            ("fsi-vanka-aux", dict(case="fsi", n=FSI_COARSE,
                                   levels=FSI_LEVELS, outer="fgmres",
                                   rtol=1e-6, restart=15, max_outer=1,
                                   smoother="vanka", mg_cycle="K",
                                   local_format="bell"), 1e-9)]


def phase_dist_partition() -> dict:
    """RCB, graph and contiguous partitions of the gambit-poisson-256 mesh
    into DIST_RANKS: edge cut, ghosts per rank and the halo plan's m and
    offsets of the Q2 operator, native and numpy seconds."""
    from femus_tpu_torch import native
    from femus_tpu_torch.algebra.sparse import pad_pattern
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.mesh import elem_neighbors
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.parallel.halo import build_halo_plan
    from femus_tpu_torch.parallel.partition import partition_mesh

    native.build()
    if native.impl() != "native":
        raise AssertionError("dist_partition: the native library is absent")
    mesh = MultiLevelMesh(unit_box((NEU_COARSE, NEU_COARSE)),
                          NEU_LEVELS).levels[-1]
    cent = mesh.coords[mesh.conn[:, :4]].mean(axis=1)
    nbr = elem_neighbors(mesh)
    rep = {"phase": "dist_partition", "n_elems": int(mesh.n_elems),
           "ranks": DIST_RANKS}
    for method in ("rcb", "graph", "contiguous"):
        t0 = time.perf_counter()
        out, info = partition_mesh(mesh, DIST_RANKS, method)
        native_s = time.perf_counter() - t0
        # the partitioner alone, native and numpy (the contiguous split
        # needs neither; the numpy region growing has no refinement sweeps)
        same = native_s1 = numpy_s = None
        if method != "contiguous":
            fn, arg = ((native.rcb_partition, cent) if method == "rcb"
                       else (native.greedy_graph_partition, nbr))
            fn_np = (native.rcb_partition_numpy if method == "rcb"
                     else native.greedy_graph_partition_numpy)
            t0 = time.perf_counter()
            part = fn(arg, DIST_RANKS)
            native_s1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            part_np = fn_np(arg, DIST_RANKS)
            numpy_s = time.perf_counter() - t0
            if method == "rcb":
                same = bool(np.array_equal(part, part_np))
        a = Assembler(out, [Unknown("u")], device="cpu")
        n = a.n_dofs
        n_pad = -(-n // DIST_RANKS) * DIST_RANKS
        plan = build_halo_plan(pad_pattern(a.pattern, n_pad, n_pad),
                               DIST_RANKS)
        rep[method] = {
            "impl": info.impl, "edge_cut": info.edge_cut,
            "elems_per_rank": np.diff(info.elem_offsets).tolist(),
            "ghosts_per_rank": [int(plan.ghost_globals(r)[1].sum())
                                for r in range(DIST_RANKS)],
            "m": plan.m, "offsets": list(plan.offs),
            "partition_mesh_s": native_s,
            "native_partitioner_s": native_s1,
            "numpy_partitioner_s": numpy_s, "numpy_rcb_equal": same,
            "n_dofs": n}
    emit(rep)
    if any(rep[m]["impl"] != "native" for m in ("rcb", "graph")):
        raise AssertionError("dist_partition: not the native partitioner")
    return rep


def _global_b1(case: str, n: int, dt):
    """(n, x, y, |A||x|) of the global B1 product of a halo case on the
    card: x as the ranks draw it (rng(0) over the padded rows)."""
    from femus_tpu_torch.algebra import bell
    from femus_tpu_torch.parallel import cases
    asm, data = cases._operator(case, n, "cuda", cases.DTYPES[dt])
    nr = asm.n_dofs
    n_pad = -(-nr // DIST_RANKS) * DIST_RANKS
    x = np.random.default_rng(0).standard_normal(n_pad)
    dev, _ = bell.bell_device_plan(asm.pattern, "identity", "cuda")
    op = bell.relayout_ell(dev, data, device="cuda")
    xt = torch.as_tensor(x[:nr], dtype=data.dtype, device="cuda")
    y = bell.spmv_bell_cuda(op, xt)
    scale = bell.spmv_bell_cuda(bell.BellOp(op.vals.abs(), op.dev), xt.abs())
    return nr, x, y.cpu().numpy(), float(scale.abs().max())


def phase_dist_halo(res: list, wall: float) -> dict:
    """The halo SpMV over DIST_RANKS ranks on the card (B1 per rank, and
    the ELL gather), held against the global B1 product: float32 within
    1e-5 max(|A||x|), float64 within 1e-12.  ``res``: each rank's
    halo_rank result from the shared launch of ``wall`` seconds."""
    from femus_tpu_torch.parallel.ranks import choose_backend

    out = {"phase": "dist_halo", **choose_backend(DIST_RANKS, "cuda"),
           "seconds": wall, "cases": {}}
    ok, launches = True, 0
    for case, n, dt in DIST_HALO_CASES:
        key = f"{case}-{n}-{dt}"
        per = [r[key] for r in res]
        nr, x, y_glob, scale = _global_b1(case, n, dt)
        tol = (1e-12 if dt == "f64" else 1e-5) * scale
        rows = {}
        for variant in per[0]["y"]:
            y = np.concatenate([p["y"][variant] for p in per])
            err = float(np.abs(y[:nr] - y_glob).max())
            pad_ok = bool(np.array_equal(y[nr:], x[nr:].astype(y.dtype)))
            rows[variant] = {
                "max_abs_err": err, "tol": tol,
                "ok": err <= tol and pad_ok,
                "b1_launches_per_rank": [p["launches"][variant]
                                         for p in per],
                "transport": per[0]["note"][variant]["transport"],
                "rule": per[0]["note"][variant]["rule"],
                "spmv_ms_per_rank": [p["ms"][variant]["spmv"] for p in per],
                "exchange_ms_per_rank": [p["ms"][variant]["exchange"]
                                         for p in per]}
            ok &= rows[variant]["ok"]
            launches += sum(p["launches"][variant] for p in per)
        blocks = [p["blocks"] for p in per]
        for b in blocks:
            for part in ("interior", "boundary"):
                if part in b:
                    ok &= b[part]["max_abs_err"] <= \
                        (1e-12 if dt == "f64" else 1e-5) * b[part]["scale"]
            # the CSR yardsticks compute the same products
            ok &= max(b["library_err"], b["library_interior_err"]) <= tol
        out["cases"][key] = {
            "n": nr, "nnz": per[0]["nnz"], "m": per[0]["m"],
            "offsets": per[0]["offsets"], "scale": scale,
            "setup_s_per_rank": [p["setup_s"] for p in per],
            "variants": rows, "blocks_per_rank": blocks}
    out["b1_launches"] = launches
    emit(out)
    if not ok:
        raise AssertionError("dist_halo: a rank's SpMV or B1 block disagrees")
    if launches <= 0:
        raise AssertionError("dist_halo: no B1 launch on the ranks")
    return out


def _b1_block_row(blocks: list, dt: str) -> dict:
    """The kernel-table row of B1 on the ranks' blocks, like with like: the
    rank whose whole local product (interior and boundary launches, the
    boundary rows added in) took longest, against one torch.sparse CSR
    product of the same rank's whole block; its bound from the bytes the
    product must move (each nonzero's value and int32 column, the
    extended x read once and y written once) and its two flops a
    nonzero.  The interior launch alone beside the CSR of the own-column
    entries rides along."""
    bl = max(blocks, key=lambda r: r["product_ms"])
    parts = [bl[p] for p in ("interior", "boundary") if p in bl]
    i = bl["interior"]
    nnz = sum(b["nnz"] for b in parts)
    nbytes = (nnz * (i["value_bytes"] + 4)
              + (i["n_cols"] + bl["ghosts"] + i["n"]) * i["x_bytes"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * nnz / (
        F64_FLOPS_PER_S if dt == "f64" else F32_FLOPS_PER_S) * 1e3
    return {"max_abs_err": max(max(b[p]["max_abs_err"] for p in
                                   ("interior", "boundary") if p in b)
                               for b in blocks),
            "ms": bl["product_ms"], "plain_ms": bl["product_plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": bl["library_ms"], "rows": i["n"], "nnz": nnz,
            "interior_ms": i["ms"],
            "interior_library_ms": bl["library_interior_ms"],
            "boundary_ms": bl["boundary"]["ms"] if "boundary" in bl
            else None}


def phase_dist_step(r4: list, wall4: float) -> dict:
    """make_sharded_step on DIST_RANKS ranks (``r4``: each rank's step_rank
    result from the shared launch of ``wall4`` seconds) against the same
    step at world size 1 (NCCL, one card): Poisson MG-CG equal iterations
    and solutions within 1e-9; the dryrun cavity step within 1e-8."""
    from femus_tpu_torch.parallel import cases
    from femus_tpu_torch.parallel.ranks import launch

    named = _dist_step_configs()
    cfgs = [cfg for _, cfg, _ in named]
    t1 = time.perf_counter()
    # world size 1 (NCCL on the one card): the same steps, and the halo
    # SpMV of phase nccl_world1 in the same launch
    case = ("poisson", NEU_COARSE << (NEU_LEVELS - 1), "f64")
    (r1, halo1), = launch(cases.calls_rank, 1, ([
        ("step_rank", (cfgs,)),
        ("halo_rank", ([case], [("bell", "auto", True)], 0, 0))],),
        device="cuda", timeout=DIST_TIMEOUT)
    r1 = [r1]
    t2 = time.perf_counter()
    rep = {"phase": "dist_step", "ranks": DIST_RANKS, "share_card": True,
           "launch_s": {"4": wall4, "1": t2 - t1}}
    ok = True
    launches = vanka_launches = 0
    for i, (name, cfg, tol) in enumerate(named):
        per4 = [r[i] for r in r4]
        one = r1[0][i]
        u4 = cases.join_rows(per4)
        u1 = one["u"][:one["n"]]
        diff = float(np.abs(u4 - u1).max())
        iters = per4[0]["iters"]
        row = {"case": cfg["case"], "n_dofs": one["n"],
               "iters_4": [p["iters"] for p in per4], "iters_1": one["iters"],
               "residual_4": per4[0]["residual"],
               "residual_1": one["residual"],
               "converged": per4[0]["converged"], "max_diff": diff,
               "tol": tol,
               # the production step (overlapped halo SpMV, no timing
               # sections), cold then warm for the timed cases
               "step_s_4": [max(p["step_s"][k] for p in per4)
                            for k in range(len(one["step_s"]))],
               "step_s_1": one["step_s"],
               "setup_s_4": max(p["setup_s"] for p in per4),
               "setup_s_1": one["setup_s"],
               "b1_launches_per_rank": [p["b1_launches"] for p in per4],
               "note_4": per4[0]["note"], "note_1": one["note"]}
        if cfg.get("timed"):
            # the instrumented step: every section synchronises the card
            # and the exchange runs before the local product
            row.update({
                "timed_step_s_4": max(p["timed_step_s"] for p in per4),
                "timed_step_s_1": one["timed_step_s"],
                "timed_max_diff": max(p["timed_diff"]
                                      for p in per4 + [one]),
                "timed_per_iteration_s_4": {
                    k: max(p["clock"][k] for p in per4) / max(iters, 1)
                    for k in per4[0]["clock"]},
                "timed_per_iteration_s_1": {
                    k: one["clock"][k] / max(iters, 1)
                    for k in one["clock"]}})
            ok &= row["timed_max_diff"] <= tol
        rep[name] = row
        launches += sum(row["b1_launches_per_rank"])
        ok &= diff <= tol and len(set(row["iters_4"])) == 1
        if name != "dryrun":
            ok &= iters == one["iters"]
        if name == "poisson":
            ok &= row["converged"]
        if cfg.get("smoother") == "vanka":
            vanka_launches += sum(row["b1_launches_per_rank"])
            ok &= min(row["b1_launches_per_rank"]) > 0
    rep["b1_launches"] = launches
    rep["vanka_b1_launches"] = vanka_launches
    emit(rep)
    if not ok:
        raise AssertionError("dist_step: 4 ranks and 1 rank disagree")
    if launches <= 0 or any(v <= 0 for v in
                            rep["poisson"]["b1_launches_per_rank"]):
        raise AssertionError("dist_step: a rank launched no B1")
    return {**rep, "world1": r1, "halo1": (case, halo1)}


def dist_patch_prep(path: str) -> dict:
    """poisson-patch-1M's finest operator (float32) on the card, its
    product with a seeded x, and the DIST_RANKS slabs of patches written
    to ``path`` for patch_rank."""
    from femus_tpu_torch.algebra import patchstencil as ps
    from femus_tpu_torch.assembly.bc import generate_bdc
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.patches import refine_patched
    from femus_tpu_torch.parallel import cases
    from femus_tpu_torch.parallel import patch_spmd as pspmd

    t0 = time.perf_counter()
    mesh, plan = refine_patched(unit_box((PATCH_COARSE, PATCH_COARSE)),
                                PATCH_LEVELS - 1)
    a = Assembler(mesh, [Unknown("u")], device="cuda", dtype=torch.float32)
    a.set_volume_form(poisson("u"))
    generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    a.set_patch_layout(plan)
    _, data = a.make_assemble_fn()(torch.zeros(a.n_dofs, device="cuda"))
    op = a.op_with(data)
    x = torch.randn(op.n_rows, generator=torch.Generator().manual_seed(0)
                    ).cuda()
    y_glob = op.matvec(x)
    scale = float(ps.spmv_patch_cuda(
        ps.PatchStencilOp(op.wt.abs(), op.routing, op.meta), x.abs()).max())
    bounds = pspmd.slab_bounds(op.meta[1], DIST_RANKS)
    cases.save_parts(path, [pspmd.patch_slab(op, lo, hi)
                            for lo, hi in bounds], x=x.cpu().numpy())
    return {"op": op, "y_glob": y_glob, "scale": scale, "bounds": bounds,
            "setup_s": time.perf_counter() - t0}


def phase_dist_patch(prep: dict, res: list, wall: float) -> dict:
    """B2 on each of DIST_RANKS slabs (``res``: each rank's patch_rank
    result from the shared launch of ``wall`` seconds), held against the
    global B2 matvec of ``prep`` at B2's budget (1e-5 max(|A||x|))."""
    op, y_glob, scale, bounds = (prep[k] for k in ("op", "y_glob", "scale",
                                                   "bounds"))
    setup_s = prep["setup_s"]
    E, P = op.meta[3], op.meta[1]
    y_int = np.concatenate([r["y_int"] for r in res], axis=2)
    y = np.concatenate([y_int.reshape(-1), res[0]["y_e"].reshape(-1),
                        res[0]["y_v"]])
    err = float(np.abs(y - y_glob.cpu().numpy()).max())
    slabs = [r["slab"] for r in res]
    rep = {"phase": "dist_patch", "ranks": DIST_RANKS, "share_card": True,
           "n": op.n_rows, "patches": P, "slabs": bounds,
           "setup_s": setup_s, "seconds": wall, "max_abs_err": err,
           "tol": 1e-5 * scale,
           "b2_launches_per_rank": [r["launches"] for r in res],
           "ms_per_rank": [r["ms"] for r in res], "slab_per_rank": slabs,
           "skeleton_values": int(res[0]["y_e"].size + res[0]["y_v"].size)}
    emit(rep)
    if not (err <= 1e-5 * scale and all(
            max(s["max_abs_err"], s["library_err"]) <= 1e-5 * s["scale"]
            for s in slabs)):
        raise AssertionError("dist_patch: the sharded matvec disagrees")
    if any(r["launches"] <= 0 for r in res):
        raise AssertionError("dist_patch: a rank launched no B2")
    # the kernel-table row: the slowest slab, its bound from its own work
    b = max(slabs, key=lambda r: r["ms"])
    H, Pl, Ppl, _, ne_, nv_, nl = b["meta"]
    nbytes, flops = patch_kernel_work(H, Pl, b["value_bytes"], nl,
                                      b["table_bytes"] // 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {**rep, "row": {
        "max_abs_err": max(s["max_abs_err"] for s in slabs), "ms": b["ms"],
        "plain_ms": b["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": b["library_ms"], "library_nnz": b["nnz"]},
        "launches": sum(r["launches"] for r in res)}


def dist_markers_prep(path: str) -> dict:
    """markers-256's cloud located on the card and written to ``path``
    for markers_rank, and the run the ranks make of it."""
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.particles.markers import MarkerCloud, locate

    mesh = unit_box((MARKERS_N, MARKERS_N))
    pts = disk_markers(MARKERS_COUNT)
    cloud = MarkerCloud(mesh, pts.copy(), np.zeros(len(pts), np.int64))
    locate(cloud, device="cuda")
    np.savez(os.path.join(path, "cloud.npz"), x=cloud.x, elem=cloud.elem)
    return {"mesh": mesh, "cloud": cloud,
            "run": dict(steps=DIST_MARKERS_STEPS, dt=DIST_MARKERS_DT,
                        order=4)}


def phase_dist_markers(prep: dict, res: list, wall: float) -> dict:
    """markers-256's cloud over DIST_RANKS ranks (``res``: each rank's
    markers_rank result from the shared launch of ``wall`` seconds):
    DIST_MARKERS_STEPS RK4 steps with all_to_all migration, against the
    same steps of the whole cloud on one rank: elements equal, positions
    to 1e-12, nothing dropped."""
    from femus_tpu_torch.parallel import cases
    from femus_tpu_torch.particles.markers import make_advect_fn
    from femus_tpu_torch.particles.sharded import collect

    mesh, cloud, dt = prep["mesh"], prep["cloud"], DIST_MARKERS_DT
    res = [r[0] for r in res]
    step = make_advect_fn(mesh, ["biquadratic"] * 2, order=4,
                          dtype=torch.float64, device="cuda")
    vel = tuple(torch.as_tensor(v, dtype=torch.float64, device="cuda")
                for v in cases.rotation_field(mesh))
    x = torch.as_tensor(cloud.x, dtype=torch.float64, device="cuda")
    e = torch.as_tensor(cloud.elem, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_MARKERS_STEPS):
        x, e = step(x, e, vel, dt)
    torch.cuda.synchronize()
    one_s = (time.perf_counter() - t0) / DIST_MARKERS_STEPS
    x1, e1 = x.cpu().numpy(), e.cpu().numpy()
    tx, te = collect(np.concatenate([r["x"] for r in res]),
                     np.concatenate([r["elem"] for r in res]))
    o1 = np.lexsort((x1[:, 1], x1[:, 0], e1))
    o4 = np.lexsort((tx[:, 1], tx[:, 0], te))
    same_n = len(te) == len(e1)
    elem_eq = same_n and bool(np.array_equal(te[o4], e1[o1]))
    pos_err = float(np.abs(tx[o4] - x1[o1]).max()) if same_n else None
    rep = {"phase": "dist_markers", "ranks": DIST_RANKS, "share_card": True,
           "markers": cloud.n, "steps": DIST_MARKERS_STEPS,
           "capacity": res[0]["capacity"],
           "cap_migrate": res[0]["cap_migrate"],
           "migrations_per_step": res[0]["migrated"],
           "dropped_per_step": res[0]["dropped"], "seconds": wall,
           "step_s_per_rank": [r["step_s"] for r in res],
           "one_rank_step_s": one_s, "elements_equal": elem_eq,
           "max_position_err": pos_err}
    emit(rep)
    if not (elem_eq and pos_err <= 1e-12 and sum(rep["dropped_per_step"]) == 0
            and sum(rep["migrations_per_step"]) > 0):
        raise AssertionError("dist_markers: the sharded cloud differs")
    return rep


def phase_nccl_world1(step: dict) -> dict:
    """The dist_halo and dist_step code at world size 1 on NCCL (run in
    dist_step's world-size-1 launch): the halo SpMV (B1, no ghosts)
    against the global B1, and the sharded steps.  One rank on one card:
    it shows that the NCCL route initialises and reduces; it is no
    multi-card test."""
    case, halo1 = step["halo1"]
    per = halo1[f"{case[0]}-{case[1]}-{case[2]}"]
    nr, x, y_glob, scale = _global_b1(*case)
    y = per["y"]["bell/auto/overlap"]
    err = float(np.abs(y[:nr] - y_glob).max())
    one = step["world1"][0]
    rep = {"phase": "nccl_world1", "multi_card_test": False,
           "world_size": 1, "backend": "nccl",
           "rule": "every rank has a card of its own (one rank, one card)",
           "halo_max_abs_err": err, "halo_tol": 1e-12 * scale,
           "halo_transport": per["note"]["bell/auto/overlap"]["transport"],
           "b1_launches": per["launches"]["bell/auto/overlap"],
           "step_poisson_iters": one[0]["iters"],
           "step_dryrun_iters": one[1]["iters"],
           "step_b1_launches": sum(c["b1_launches"] for c in one)}
    emit(rep)
    if not (err <= 1e-12 * scale and rep["b1_launches"] > 0):
        raise AssertionError("nccl_world1: the world-1 halo SpMV disagrees")
    return rep


def patch3d_system(coarse: int, levels: int, device, dtype, rtol: float):
    """Q2 Poisson with the sin sin sin solution, operator="patch" and
    rediscretized coarse levels on a hex patch hierarchy."""
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import PatchedMultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    pi = np.pi
    ml_mesh = PatchedMultiLevelMesh(unit_box((coarse,) * 3, "hex"), levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc("u")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(LinearImplicitSystem, "patch3d")
    sys_.add_unknown("u")
    sys_.set_assembly(poisson("u", rhs=lambda x: 3 * pi ** 2
                              * torch.sin(pi * x[:, 0])
                              * torch.sin(pi * x[:, 1])
                              * torch.sin(pi * x[:, 2])))
    cfg = sys_.config
    cfg.operator, cfg.coarse_op = "patch", "rediscretize"
    cfg.smoother, cfg.mg_type, cfg.rtol = "chebyshev", "V", rtol
    sys_.init(device=device, dtype=dtype)
    return sys_, ml_mesh, ml_sol


def phase_patch3d() -> dict:
    """patch3d: the 3-D patch operator's matvec against B1 on the ELL
    operator of the same matrix at the 117,649-dof level (1e-5
    relative), the patch solve on the card, and a small card-against-host
    reference."""
    from femus_tpu_torch.algebra import bell
    from femus_tpu_torch.assembly.bc import generate_bdc
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    sys_, ml_mesh, ml_sol = patch3d_system(PATCH3D_COARSE, PATCH3D_LEVELS,
                                           "cuda", torch.float32, 1e-6)
    setup_s = time.perf_counter() - t0
    a = sys_.assemblers[-1]
    _, wt = a.make_assemble_fn()(torch.zeros(a.n_dofs, device="cuda"))
    op3 = a.op_with(wt)
    x = torch.randn(a.n_dofs, generator=torch.Generator().manual_seed(0)
                    ).cuda()
    patch_ms = time_ms(lambda: op3 @ x, reps=10, warm=2)
    del wt
    # the same matrix on the ELL layout through B1, at the level below
    # the finest (PATCH3D_ELL_LEVEL): the finest level's ELL set-up took
    # 436 s on the host of an H100 machine
    a2 = sys_.assemblers[PATCH3D_ELL_LEVEL]
    zero = torch.zeros(a2.n_dofs, device="cuda")
    _, wt2 = a2.make_assemble_fn()(zero)
    op2 = a2.op_with(wt2)
    x2 = x[:a2.n_dofs].contiguous()
    y3 = op2 @ x2
    t0 = time.perf_counter()
    e = Assembler(ml_mesh.levels[PATCH3D_ELL_LEVEL], [Unknown("u")],
                  device="cuda", dtype=torch.float32)
    e.set_volume_form(poisson("u"))
    generate_bdc(e, lambda var, x, grp, t: (True, 0.0))
    _, data = e.make_assemble_fn()(zero)
    dev = bell.build_sell_plan(e.pattern, "identity").to_device("cuda")
    ell_s = time.perf_counter() - t0
    bop = bell.relayout_ell(dev, data, device="cuda")
    y1 = bell.spmv_bell_cuda(bop, x2)
    scale = float(bell.spmv_bell_cuda(bell.BellOp(bop.vals.abs(), bop.dev),
                                      x2.abs()).max())
    err = float((y3 - y1).abs().max())
    b1_ms = time_ms(lambda: bell.spmv_bell_cuda(bop, x2), reps=10, warm=2)
    nnz = int(e.pattern.nnz)
    del e, data, bop, dev, wt2, op2
    reset_launches()
    t0 = time.perf_counter()
    info = sys_.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = launch_counts()
    xyz = ml_mesh.levels[-1].node_coords_of("biquadratic")
    exact = np.prod(np.sin(np.pi * xyz), axis=1)
    nodal = float(np.abs(ml_sol.sol[-1]["u"] - exact).max())
    # small reference: the card's float32 solve against the host's float64
    fields = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        s_, _, sol_ = patch3d_system(2, 3, device, dtype, 1e-8)
        s_.solve()
        fields[device] = sol_.sol[-1]["u"].copy()
    ref = float(np.linalg.norm(fields["cuda"] - fields["cpu"])
                / np.linalg.norm(fields["cpu"]))
    rep = {"phase": "patch3d", "n_dofs": [al.n_dofs for al in
                                          sys_.assemblers],
           "H": op3.meta[0], "patches": op3.meta[1], "Pp": op3.meta[2],
           "weights_bytes": op3.wt.numel() * op3.wt.element_size(),
           "setup_s": setup_s, "ell_level_n_dofs": int(x2.numel()),
           "ell_setup_s": ell_s, "ell_nnz": nnz,
           "matvec_vs_b1_err": err, "scale": scale,
           "patch_matvec_ms": patch_ms, "ell_level_b1_ms": b1_ms,
           "gmres_iters": info["iters"], "converged": info["converged"],
           "residual": info["residual"], "target": info["target"],
           "solve_s": solve_s, "max_nodal_err": nodal,
           "kernel_launches": launches, "card_vs_host": ref,
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not err <= 1e-5 * scale:
        raise AssertionError("patch3d: the 3-D patch matvec and B1 differ")
    if not (info["converged"] and nodal < PATCH_ERR_MAX and ref < 1e-4):
        raise AssertionError(f"patch3d: solve or reference failed ({rep})")
    return rep


def run_slice10() -> dict:
    """The slice-10 phases in order (the CUDA and native libraries are
    built before any rank starts: ranks building into build/ at once would
    race on one .so)."""
    from femus_tpu_torch import native
    from femus_tpu_torch._cuda_build import KERNEL_SOURCES, build
    from femus_tpu_torch.parallel import cases
    from femus_tpu_torch.parallel.ranks import launch

    build(KERNEL_SOURCES)
    native.build()
    out = {"partition": phase_dist_partition()}
    # one launch of DIST_RANKS processes runs the rank programs of
    # dist_halo, dist_step, dist_patch and dist_markers in turn (a launch
    # costs its processes' start-up; the phase lines report its seconds)
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("patch", "markers"):
            os.makedirs(os.path.join(tmp, sub))
        patch = dist_patch_prep(os.path.join(tmp, "patch"))
        markers = dist_markers_prep(os.path.join(tmp, "markers"))
        t0 = time.perf_counter()
        res = launch(cases.calls_rank, DIST_RANKS, ([
            ("halo_rank", (DIST_HALO_CASES, DIST_VARIANTS, 0, DIST_REPS)),
            ("step_rank", ([cfg for _, cfg, _ in _dist_step_configs()],)),
            ("patch_rank", (os.path.join(tmp, "patch"), DIST_REPS)),
            ("markers_rank", (os.path.join(tmp, "markers"), MARKERS_N,
                              [markers["run"]]))],),
            device="cuda", timeout=DIST_TIMEOUT)
        wall = time.perf_counter() - t0
    out["halo"] = phase_dist_halo([r[0] for r in res], wall)
    out["step"] = phase_dist_step([r[1] for r in res], wall)
    out["patch"] = phase_dist_patch(patch, [r[2] for r in res], wall)
    out["markers"] = phase_dist_markers(markers, [r[3] for r in res], wall)
    del patch
    out["nccl"] = phase_nccl_world1(out["step"])
    out["patch3d"] = phase_patch3d()
    return out


# ---------------------------------------------------------------------------
# slice 11: the System diagnostics, the profiler trace, the writers and the
# checkpoints, on the solved cavity-128 of slice 1 (the main path's system,
# float32, B1), and the sharded step's Vanka smoother and aux fields (two
# more dist_step configs)
# ---------------------------------------------------------------------------

# relative gap allowed between the ends of one Newton step from the saved
# state and one from the restored state (float32; index_add_ atomics on
# the card do not repeat bit for bit), relative to the end
CKPT_STEP_RTOL = 1e-5
# From the solved state a step's update is float32 rounding (1e-7 to
# 1.4e-5 of u): two such steps differed by 8.5e-4 to 0.2 of the update on
# an NVIDIA H100 80GB HBM3, 700.00 W, so their updates say nothing of the
# restored System.  The updates are compared from a kicked start instead:
# the free dofs of the state scaled by 1 + CKPT_KICK, which one step
# visibly corrects (the update is then 0.97 % of the end).
# CKPT_UPDATE_RTOL bounds the gap between the updates of a step from the
# saved and from the restored kicked state, relative to the update: 5 x 5
# such pairs differed by 2.4e-6 to 1.4e-4, two steps from the saved state
# by 7.5e-6 to 1.9e-4, all with 6 GMRES iterations (the same card,
# tools/torch_checkpoint_step_gap.py); a step that does nothing differs
# by 1
CKPT_KICK, CKPT_UPDATE_RTOL = 1e-2, 1e-2


def _b1_launches() -> int:
    from femus_tpu_torch.systems.system import launch_counts
    return launch_counts()["bell_spmv"]


def phase_diagnostics(sys_, ml_sol) -> dict:
    """System.profile_step(-1, reps=3) on the solved cavity-128: the
    assembly, coarsening (the finest transfer's PtAP schedule) and solve
    step seconds, each the best of 3 after a warm call ending in
    torch.cuda.synchronize(); the B1 launches of the profiled calls (all
    in the solve-step phase), peak device bytes; dofmap_size of u, v, p
    against the solution's sizes and the dof maps'."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prof = sys_.profile_step(-1, reps=3)
    wall = time.perf_counter() - t0
    launches = _b1_launches()
    mesh = sys_.ml_mesh.levels[-1]
    sizes = {n: {"dofmap_size": sys_.dofmap_size(n, -1),
                 "solution": int(ml_sol.sol[-1][n].shape[0]),
                 "dofmap": mesh.dofmap(ml_sol.vars[n].family).n_dofs}
             for n in ("u", "v", "p")}
    rep = {"phase": "diagnostics", "profile_step": prof, "wall_s": wall,
           "timing": {k: sys_.timing[k] for k in prof},
           "b1_launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "dofmap_size": sizes}
    emit(rep)
    if set(prof) != {"assembly_s", "coarsen_s", "solve_step_s"} or not all(
            v > 0 for v in prof.values()):
        raise AssertionError(f"diagnostics: profile_step gave {prof}")
    if launches <= 0:
        raise AssertionError("diagnostics: the solve step launched no B1")
    if any(len(set(v.values())) != 1 for v in sizes.values()):
        raise AssertionError(f"diagnostics: dofmap sizes {sizes}")
    return rep


def phase_trace(sys_) -> dict:
    """One Newton step of the solved cavity-128 under
    utils.telemetry.trace: the exported Chrome trace must name B1's
    kernel (the profiler sees the card)."""
    from femus_tpu_torch.utils.telemetry import trace
    step = sys_.step_fn(-1)
    u = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype,
                        device=sys_.device)
    step(u)                                   # warm
    reset_launches()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with trace(d) as h:
            out = step(u)
        wall = time.perf_counter() - t0
        launches = _b1_launches()
        size = os.path.getsize(h.path)
        events = json.load(open(h.path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    b1 = [e for e in kernels if "sell_spmv" in e.get("name", "")]
    rep = {"phase": "trace", "wall_s": wall, "trace_bytes": size,
           "events": len(events), "kernel_events": len(kernels),
           "b1_kernel_events": len(b1),
           "b1_kernel_us": sum(e.get("dur", 0.0) for e in b1),
           "kernel_us": sum(e.get("dur", 0.0) for e in kernels),
           "b1_launches": launches, "gmres_iters": out.lin_iters,
           "b1_name": b1[0]["name"] if b1 else None}
    emit(rep)
    if not b1 or launches <= 0:
        raise AssertionError("trace: the exported trace names no B1 kernel")
    return rep


def _vtu_point_data(path: str) -> dict:
    """The point-data arrays of a .vtu written by io.vtk (base64 binary
    payloads, float32)."""
    import base64
    import re
    txt = open(path).read()
    block = txt.split("<PointData>")[1].split("</PointData>")[0]
    out = {}
    for name, blob in re.findall(
            r'<DataArray type="Float32" Name="([^"]+)"[^>]*>\n([^\n]*)\n',
            block):
        raw = base64.b64decode(blob)
        n = int.from_bytes(raw[:4], "little")
        out[name] = np.frombuffer(raw[4:4 + n], np.float32)
    return out


def phase_writers(ml_sol) -> dict:
    """VTKWriter and GMVWriter of the finest u, v, p (seconds, bytes); the
    GMV file read back by read_gmv and the VTU parsed back equal
    nodal_field exactly (float64 in GMV, float32 in VTU).  XDMF runs only
    where h5py is installed (importlib.util.find_spec)."""
    import importlib.util

    from femus_tpu_torch.io import GMVWriter, VTKWriter, nodal_field, read_gmv
    mesh = ml_sol.ml_mesh.levels[-1]
    names = ("u", "v", "p")
    ref = {n: nodal_field(mesh, ml_sol.vars[n].family, ml_sol.sol[-1][n])
           for n in names}
    rep = {"phase": "writers", "n_nodes": mesh.n_nodes,
           "n_elems": mesh.n_elems}
    ok = True
    with tempfile.TemporaryDirectory() as d:
        for kind, writer in (("vtk", VTKWriter), ("gmv", GMVWriter)):
            t0 = time.perf_counter()
            path = writer(ml_sol).write(d, *names)
            rep[kind] = {"seconds": time.perf_counter() - t0,
                         "bytes": os.path.getsize(path)}
            if kind == "vtk":
                back = _vtu_point_data(path)
                same = {n: bool(np.array_equal(back[n],
                                               ref[n].astype(np.float32)))
                        for n in names}
            else:
                _, conn, pd, _ = read_gmv(path)
                same = {n: bool(np.array_equal(pd[n], ref[n]))
                        for n in names}
                same["conn"] = conn.shape == (mesh.n_elems, 8)
            rep[kind]["read_back_equal"] = same
            ok &= all(same.values())
        if importlib.util.find_spec("h5py") is None:
            rep["xdmf"] = "not run: h5py is not installed"
        else:
            from femus_tpu_torch.io import XDMFWriter, read_xdmf_h5
            t0 = time.perf_counter()
            path = XDMFWriter(ml_sol).write(d, *names)
            back = read_xdmf_h5(path)["mesh0"]
            rep["xdmf"] = {"seconds": time.perf_counter() - t0,
                           "bytes": os.path.getsize(path[:-4] + ".h5"),
                           "read_back_equal": all(
                               np.array_equal(back[n], ref[n])
                               for n in names)}
            ok &= rep["xdmf"]["read_back_equal"]
    emit(rep)
    if not ok:
        raise AssertionError("writers: a file read back differs")
    return rep


def kicked_start(s) -> torch.Tensor:
    """The finest state of System ``s`` with its free (non-Dirichlet)
    dofs scaled by 1 + CKPT_KICK, on the system's device."""
    u = s.gather(-1)
    u = np.where(s.masks[-1], u, u * (1.0 + CKPT_KICK))
    return torch.as_tensor(u, dtype=s.dtype, device=s.device)


def phase_checkpoint(sys_, ml_sol) -> dict:
    """capture_solution -> CheckpointManager.save -> a freshly
    initialised cavity-128 System -> restore: the restored host arrays
    equal the saved ones exactly; then one Newton step (the solve step,
    its state left alone) from each, whose ends agree within
    CKPT_STEP_RTOL, and one from each kicked state, whose updates (end -
    start) agree within CKPT_UPDATE_RTOL, relative (beside the gap
    between two steps from the saved kicked state)."""
    from femus_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                  capture_solution,
                                                  restore_solution)
    rep = {"phase": "checkpoint"}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        state = {"solution": capture_solution(ml_sol)}
        mgr = CheckpointManager(d, max_to_keep=1)
        mgr.save(5, state)
        rep["save_s"] = time.perf_counter() - t0
        rep["bytes"] = os.path.getsize(os.path.join(d, "ckpt_5",
                                                    "state.npz"))
        t0 = time.perf_counter()
        sys2, sol2 = cavity_system(
            COARSE_CELLS, LEVELS, sys_.device, sys_.dtype,
            rtol=sys_.config.rtol, max_nonlinear=sys_.config.max_nonlinear)
        rep["fresh_init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_solution(sol2, mgr.restore()["solution"])
        rep["restore_s"] = time.perf_counter() - t0
    equal = all(np.array_equal(a[k], b[k])
                for src, dst in ((ml_sol.sol, sol2.sol),
                                 (ml_sol.sol_old, sol2.sol_old))
                for a, b in zip(src, dst) for k in a)
    reset_launches()
    runs = []
    # as restored: saved, restored; kicked: saved, restored, and saved
    # again (the card's own repeat gap)
    for s, kick in ((sys_, False), (sys2, False), (sys_, True),
                    (sys2, True), (sys_, True)):
        u = (kicked_start(s) if kick else
             torch.as_tensor(s.gather(-1), dtype=s.dtype, device=s.device))
        t0 = time.perf_counter()
        out = s.step_fn(-1)(u)
        torch.cuda.synchronize()
        runs.append((out.u.double(), out.u.double() - u.double(),
                     time.perf_counter() - t0, out.lin_iters))
    (end0, *_), (end1, *_), (kend, upd0, *_), (_, upd1, *_), \
        (_, upd2, *_) = runs
    norm = lambda x: float(torch.linalg.norm(x))          # noqa: E731
    rel = norm(end0 - end1) / norm(end0)
    rel_upd = norm(upd0 - upd1) / norm(upd0)
    rep.update({"arrays_equal": equal, "step_rel_diff": rel,
                "rtol": CKPT_STEP_RTOL, "kick": CKPT_KICK,
                "update_rel_diff": rel_upd,
                "update_rtol": CKPT_UPDATE_RTOL,
                "update_repeat_rel_diff": norm(upd0 - upd2) / norm(upd0),
                "update_rel_size": norm(upd0) / norm(kend),
                "step_s": [r[2] for r in runs],
                "gmres_iters": [r[3] for r in runs],
                "b1_launches": _b1_launches()})
    del sys2, sol2
    emit(rep)
    if not equal:
        raise AssertionError("checkpoint: restored arrays differ")
    if not rel <= CKPT_STEP_RTOL:
        raise AssertionError(f"checkpoint: steps differ by {rel:.3g}")
    if not rel_upd <= CKPT_UPDATE_RTOL:
        raise AssertionError(f"checkpoint: the steps' updates differ by "
                             f"{rel_upd:.3g}")
    if rep["b1_launches"] <= 0:
        raise AssertionError("checkpoint: the steps launched no B1")
    return rep


def run_slice11(sys_, ml_sol) -> dict:
    """The slice-11 phases on the solved cavity-128 (the sharded Vanka
    and aux-field steps run inside dist_step, slice 10)."""
    return {"diagnostics": phase_diagnostics(sys_, ml_sol),
            "trace": phase_trace(sys_), "writers": phase_writers(ml_sol),
            "checkpoint": phase_checkpoint(sys_, ml_sol)}


# ---------------------------------------------------------------------------
# slice 12: the golden apps and the ten examples.  ns-channel is the JAX
# main path's own builder (apps.ns_bench.make_ns_system at bench.py's
# bench_newton_step settings: rtol 1e-4, interleaved dofs, operator "bell",
# float32) on the Turek-style channel of channel_neu (the reference's
# nsbenc.neu is absent); fsi-channel is apps.fsi_bench.make_fsi_system on
# the same channel with a beam; the examples run at their JAX defaults
# ---------------------------------------------------------------------------

# ns-channel: coarse cells along and across the channel, make_ns_system's
# default depth (finest 22,272 quads, 246,784 dofs) and the Newton steps a
# level (float32 cannot meet the builder's nonlinear_tol of 1e-9)
CHANNEL_NX, CHANNEL_NY, CHANNEL_LEVELS, CHANNEL_NEWTON = 44, 8, 4, 5
# fsi-channel: make_fsi_system on the channel with the beam at 2 levels
# (27,344 dofs), K-cycle, float64, with the reference's inexact Newton
# (max_lin_iters=20: one FGMRES(20) cycle a step).  Two levels, not the
# builder's 4, is a cut forced by the solver: at 3 levels (107,584 dofs)
# the K-cycle does not converge on this channel.  ||R(u)|| stays at
# 4.2438e-4 with the inexact Newton (a fall of 45.6x where the gate asks
# 10^3) and at 2.43e-4 with every solve given 1,200 iterations
# (max_lin_iters=0, none reaching 1e-8).  The JAX package stalls alike at
# that configuration on the host (`python tests/test_torch_apps_fsi.py 44
# 8 3`): its ||R(u)|| after each of the 15 finest steps lies within 1.4e-4
# of the port's on the card, 4.243771e-4 at the end, a fall of 45.57x
FSI_CHANNEL_LEVELS, FSI_CHANNEL_LIN_ITERS = 2, 20
# ex08's disk: coarse cells per side of disk_neu's box
EX08_DISK_N = 8
# ex03 at its default EX_N = 16 does not reach its nonlinear_tol of 1e-9 in
# either package: its Jacobi-GMRES(30) stops at its 600 iterations short of
# 1e-10 in every Newton step, so each step is inexact.  On the host the two
# packages print the same lin_res and max_eps for steps 0-2 and differ in
# the fourth digit from step 3 (4.161e-4 against 4.160e-4); the gap then
# grows to a factor 2.4 at step 14 (max_eps 7.6e-7 in the JAX example,
# 1.8e-6 in the port) while both fall about 2.7x a step.  Two runs of the
# port on the card (whose index_add_ atomics reorder sums) drift from each
# other alike (max_eps 1.712e-2 and 1.638e-2 at step 4, 8.7e-7 and 2.0e-6
# at step 14): rounding carried by the inexact steps.  The gate there
# is EX03_DEFAULT_EPS, and the claim itself is held at EX03_SMALL_N, where
# the linear solves converge and both print the same lines to 5.3e-12
EX03_DEFAULT_EPS, EX03_SMALL_N = 1e-5, 6
# ex10's ranks on the card: the JAX example's own default,
# min(len(jax.devices()), 8), on a machine of one card (its 4 gloo ranks
# sharing the card took 62-83 s of the run's clock, 2,700 host-staged GMRES
# iterations; tests/test_torch_examples_sharded.py holds one rank and 4
# ranks against JAX on the host, and dist_step and dist_markers run the
# sharded step and the marker migration on 4 ranks on the card)
EX10_RANKS = 1
# examples whose returned numbers the host (float64) reproduces to
# EXAMPLES_HOST_RTOL
EXAMPLES_ON_HOST, EXAMPLES_HOST_RTOL = ("ex01", "ex02", "ex04", "ex07"), 1e-8


def _newton_by_level(hist) -> dict:
    """Newton steps, Krylov iterations, seconds and ||R(u)|| at each
    step's input, by level."""
    out = {}
    for h in hist:
        lv = out.setdefault(str(h["level"]), {
            "newton_steps": 0, "lin_iters": [], "seconds": [],
            "res_norm": [], "lin_converged": []})
        lv["newton_steps"] += 1
        lv["lin_iters"].append(h["lin_iters"])
        lv["seconds"].append(h["seconds"])
        lv["res_norm"].append(h["res_norm"])
        lv["lin_converged"].append(h["converged"])
    return out


def phase_channel_setup(path: str) -> tuple:
    """ns-channel through the JAX main path's builder, as bench.py's
    bench_newton_step configures it."""
    from femus_tpu_torch.apps import ns_bench

    t0 = time.perf_counter()
    prob, sys_ = ns_bench.make_ns_system(
        levels=CHANNEL_LEVELS, rtol=1e-4, interleave=True, mesh_path=path,
        device="cuda", dtype=torch.float32)
    sys_.config.operator = "bell"
    sys_.config.max_nonlinear = CHANNEL_NEWTON
    setup_s = time.perf_counter() - t0
    emit({"phase": "channel_setup", "seconds": setup_s,
          "coarse_cells": [CHANNEL_NX, CHANNEL_NY],
          "n_dofs": sys_.assemblers[-1].n_dofs,
          "levels": [a.n_dofs for a in sys_.assemblers],
          "elements": sys_.ml_mesh.finest().n_elems})
    return prob, sys_, setup_s


def phase_channel_main(prob, sys_, setup_s: float) -> dict:
    """The F-cycle ratchet of ns-channel (up to CHANNEL_NEWTON Newton steps
    a level), then make_temperature_system in the solved velocity (float64:
    its rtol is 1e-10); the launch counts set to 0 just before the NS
    solve and read just after."""
    from femus_tpu_torch.apps import ns_bench
    from femus_tpu_torch.systems.system import launch_counts

    res0 = _res_norm(sys_)
    reset_launches()
    _flush_buffer.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    final = _res_norm(sys_)
    t0 = time.perf_counter()
    sysT = ns_bench.make_temperature_system(prob, device="cuda",
                                            dtype=torch.float64)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    info = sysT.solve()
    torch.cuda.synchronize()
    T = prob.ml_sol.sol[-1]["T"]
    rep = {"phase": "channel_main", "setup_s": setup_s, "wall_s": wall,
           "by_level": _newton_by_level(sys_.history),
           "newton_steps": len(sys_.history),
           "initial_res_norm": res0, "final_res_norm": final,
           "res_norm_drop": res0 / max(final, 1e-300),
           "linear_solves_converged": all(h["converged"]
                                          for h in sys_.history),
           "kernel_launches": launches, "peak_device_bytes": peak,
           "fields_finite": all(np.all(np.isfinite(prob.ml_sol.sol[-1][n]))
                                for n in ("U", "V", "P")),
           "norms": {n: float(np.linalg.norm(prob.ml_sol.sol[-1][n]))
                     for n in ("U", "V", "P")},
           "temperature": {"setup_s": t_setup,
                           "seconds": time.perf_counter() - t0,
                           "iters": info["iters"],
                           "residual": info["residual"],
                           "target": info["target"],
                           "converged": info["converged"],
                           "norm": float(np.linalg.norm(T)),
                           "min": float(T.min()), "max": float(T.max())},
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not rep["linear_solves_converged"]:
        raise AssertionError("channel_main: a linear solve missed its rtol")
    if not rep["res_norm_drop"] >= 1e3:
        raise AssertionError(f"channel_main: ||R(u)|| fell only "
                             f"{rep['res_norm_drop']:.3g}x")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("channel_main: the solve launched no B1")
    if not (rep["fields_finite"] and info["converged"]
            and np.isfinite(rep["temperature"]["norm"])):
        raise AssertionError(f"channel_main: temperature: {rep}")
    return rep


def _solid_det_f(sys_) -> tuple:
    """(min, max) of det(I + grad d) at the quadrature points of the solid
    elements of the finest level."""
    from femus_tpu_torch.apps.fsi_bench import SOLID_GROUP
    from femus_tpu_torch.assembly.engine import ElemOpsBatched

    a = sys_.assemblers[-1]
    t = a.device_tables_cached()
    ops = ElemOpsBatched(t["tabs"], t["qweights"],
                         t["coords_e"].permute(1, 2, 0), 2)
    conn = a.dofmaps["DX"].conn.T
    sol = sys_.ml_sol.sol[-1]
    G = torch.stack([ops.grad("biquadratic", torch.as_tensor(
        sol[c][conn], dtype=sys_.dtype, device="cuda"))
        for c in ("DX", "DY")], dim=1)
    F = G + torch.eye(2, dtype=G.dtype, device="cuda")[None, :, :, None]
    J = (F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0])
    J = J[:, torch.as_tensor(a.mesh.elem_group == SOLID_GROUP,
                             device="cuda")]
    return float(J.min()), float(J.max())


def phase_fsi_channel(path: str) -> dict:
    """fsi-channel: make_fsi_system (K-cycle, max_lin_iters
    FSI_CHANNEL_LIN_ITERS, operator "bell", float64) over
    FSI_CHANNEL_LEVELS levels; the launch counts set to 0 just before the
    solve and read just after."""
    from femus_tpu_torch.apps import fsi_bench
    from femus_tpu_torch.systems.system import launch_counts

    t0 = time.perf_counter()
    _, sys_ = fsi_bench.make_fsi_system(
        levels=FSI_CHANNEL_LEVELS, mg_cycle="K",
        max_lin_iters=FSI_CHANNEL_LIN_ITERS,
        cfg_overrides={"operator": "bell"}, mesh_path=path, device="cuda",
        dtype=torch.float64)
    setup_s = time.perf_counter() - t0
    res0 = _res_norm(sys_)
    reset_launches()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    final = _res_norm(sys_)
    mesh = sys_.ml_mesh.finest()
    xy = mesh.coords[mesh.dofmap("biquadratic").nodes]
    solid = fsi_bench.solid_mark(mesh)[mesh.dofmap("biquadratic").nodes] > 0
    tip = solid & np.isclose(xy[:, 0], xy[solid, 0].max())
    sol = sys_.ml_sol.sol[-1]
    det_min, det_max = _solid_det_f(sys_)
    rep = {"phase": "fsi_channel", "setup_s": setup_s, "solve_s": wall,
           "n_dofs": [a.n_dofs for a in sys_.assemblers],
           "by_level": _newton_by_level(sys_.history),
           "newton_steps": len(sys_.history),
           "max_lin_iters": FSI_CHANNEL_LIN_ITERS,
           "linear_solves_converged": all(h["converged"]
                                          for h in sys_.history),
           "initial_res_norm": res0, "final_res_norm": final,
           "res_norm_drop": res0 / max(final, 1e-300),
           "beam_tip_dy": float(sol["DY"][tip].mean()),
           "beam_tip_dx": float(sol["DX"][tip].mean()),
           "det_f_solid": [det_min, det_max],
           "norms": {n: float(np.linalg.norm(sol[n]))
                     for n in ("DX", "DY", "U", "V", "P")},
           "kernel_launches": launches,
           "fields_finite": all(np.all(np.isfinite(sol[n]))
                                for n in ("DX", "DY", "U", "V", "P")),
           "routing": sys_.solver_info()["routing"]}
    emit(rep)
    if not rep["res_norm_drop"] >= 1e3:
        raise AssertionError(f"fsi_channel: ||R(u)|| fell only "
                             f"{rep['res_norm_drop']:.3g}x")
    if not (det_min > 0 and rep["fields_finite"]):
        raise AssertionError(f"fsi_channel: det F or fields: {rep}")
    if launches["bell_spmv"] <= 0:
        raise AssertionError("fsi_channel: the solve launched no B1")
    return rep


def _example_gates(name: str, r: dict) -> bool:
    """The claim each example prints (ex08-ex10 assert their own)."""
    if name == "ex01":
        deg = {"linear": 2, "serendipity": 3, "biquadratic": 3,
               "disc_constant": 1, "disc_linear": 2}
        return all(abs(r[f]["order"] - p) < 0.3 for f, p in deg.items())
    if name == "ex02":
        return all(abs(r[f]["l2_orders"][-1] - p) < 0.2 for f, p in
                   (("linear", 2), ("serendipity", 3), ("biquadratic", 3)))
    if name == "ex03":
        return (r["max_eps"] < EX03_DEFAULT_EPS and r["max_abs_u"] == 1.0
                and r["small"]["max_eps"] < r["small"]["nonlinear_tol"]
                and r["small"]["max_abs_u"] == 1.0)
    if name == "ex04":
        return (abs(r["cn"]["order"] - 2) < 0.2
                and r["rk"]["l2"][-1] < r["cn"]["l2"][-1])
    if name == "ex05":
        return (r["in_domain"] == r["markers"] == 50 and r["captured"] >= 1
                and r["mean_dist_after"] < r["mean_dist_before"])
    if name == "ex06":
        return (r["com_y"][-1] < r["com_y"][0]
                and 0 < r["det_min"] <= r["det_max"] < np.inf)
    if name == "ex07":
        return (np.isfinite([r["mean"], r["var"]]).all() and r["var"] > 0
                and np.isfinite(r["pdf"]).all() and min(r["pdf"]) >= 0)
    return True


def _numbers(r, path: str = "") -> dict:
    """Every number in an example's returned dict, by its key path."""
    if isinstance(r, dict):
        out = {}
        for k in sorted(r):
            out.update(_numbers(r[k], f"{path}/{k}"))
        return out
    if isinstance(r, (bool, str)):
        return {}
    return {path: np.atleast_1d(np.asarray(r, dtype=np.float64)).ravel()}


def _host_rel_diff(card: dict, host: dict) -> float:
    """The largest difference between the card's and the host's returned
    numbers, each relative to the largest of its kind (key path)."""
    a, b = _numbers(card), _numbers(host)
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        return float("inf")
    return max(float(np.abs(a[k] - b[k]).max()
                     / max(np.abs(b[k]).max(), 1e-300)) for k in a)


def phase_examples(disk: str, out_dir: str) -> dict:
    """The ten examples at their JAX defaults on the card (float64; ex10 on
    EX10_RANKS ranks; ex03 also at EX03_SMALL_N), their
    printed lines captured; ex01,
    ex02, ex04 and ex07 also on the host, every returned number within
    EXAMPLES_HOST_RTOL (relative to the largest of its kind) of the
    card's."""
    import importlib
    import io

    names = ["ex01_function_approximation", "ex02_poisson_convergence",
             "ex03_navier_stokes_cavity", "ex04_transient_heat_rk",
             "ex05_markers_magnetic", "ex06_mpm_fsi_block", "ex07_uq_pce",
             "ex08_tumor_diffusion", "ex09_amr_mg",
             "ex10_sharded_transient_particles"]
    for k in ("EX_N", "EX_STEPS", "EX_LEVELS", "EX_CYCLES", "EX_D2"):
        os.environ.pop(k, None)
    os.environ["EX_OUT"] = os.path.join(out_dir, "cavity.vtu")
    rep = {"phase": "examples", "disk_coarse": EX08_DISK_N}
    ok = True
    for full in names:
        short = full[:4]
        mod = importlib.import_module(f"femus_tpu_torch.examples.{full}")
        kw = ({"mesh_path": disk} if short == "ex08" else
              {"n_ranks": EX10_RANKS} if short == "ex10" else {})
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = mod.main(device="cuda", **kw)
            if short == "ex03":
                os.environ["EX_N"] = str(EX03_SMALL_N)
                got["small"] = mod.main(device="cuda")
                del os.environ["EX_N"]
        torch.cuda.synchronize()
        row = {"seconds": time.perf_counter() - t0,
               "printed": buf.getvalue().splitlines(),
               "gates": _example_gates(short, got)}
        if short in EXAMPLES_ON_HOST:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                host = mod.main(device="cpu", **kw)
            row["host_seconds"] = time.perf_counter() - t0
            row["host_max_rel_diff"] = _host_rel_diff(got, host)
            row["gates"] &= row["host_max_rel_diff"] <= EXAMPLES_HOST_RTOL
        rep[short] = row
        ok &= row["gates"]
    emit(rep)
    if not ok:
        raise AssertionError("examples: a gate failed: " + json.dumps(
            {k: v for k, v in rep.items()
             if isinstance(v, dict) and not v["gates"]}))
    return rep


def run_slice12() -> dict:
    """The slice-12 phases in order (the rank processes of ex10 start after
    the kernels are built)."""
    with tempfile.TemporaryDirectory() as tmp:
        ch = channel_neu(os.path.join(tmp, "channel.neu"), CHANNEL_NX,
                         CHANNEL_NY)
        prob, sys_, setup_s = phase_channel_setup(ch)
        k = phase_kernel(sys_, "channel_kernel")
        main = phase_channel_main(prob, sys_, setup_s)
        del prob, sys_
        disk = disk_neu(os.path.join(tmp, "disk.neu"), EX08_DISK_N)
        ex = phase_examples(disk, tmp)
        beam = channel_neu(os.path.join(tmp, "beam.neu"), CHANNEL_NX,
                           CHANNEL_NY, solid=True)
        fsi = phase_fsi_channel(beam)
    return {"kernel": k, "main": main, "fsi": fsi, "examples": ex}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one Newton step, one patch solve "
                         "step, one lattice CG solve, one KKT solve step "
                         "and one FSI Newton step (device time by kernel, "
                         "idle share)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    try:
        import femus_tpu_torch  # noqa: F401  (needs the repo checkout)
        card = card_line()
        phase_build(card)
        t0 = time.perf_counter()
        sys_, ml_sol = cavity_system(COARSE_CELLS, LEVELS, "cuda",
                                     torch.float32, rtol=1e-4,
                                     max_nonlinear=5)
        emit({"phase": "setup", "seconds": time.perf_counter() - t0,
              "n_dofs": sys_.assemblers[-1].n_dofs,
              "levels": [a.n_dofs for a in sys_.assemblers]})
        k = phase_kernel(sys_)
        launches = phase_main(sys_, ml_sol)
        if args.profile:
            phase_profile(sys_, torch.as_tensor(
                sys_.gather(-1), dtype=sys_.dtype, device="cuda"), "NS")
        # slice 11: diagnostics, trace, writers and checkpoints on the
        # solved cavity-128 (its state left as the solve left it)
        s11 = run_slice11(sys_, ml_sol)
        galerkin = {"fields": {n: ml_sol.sol[-1][n].copy()
                               for n in ("u", "v", "p")},
                    "history": sys_.history}
        del sys_, ml_sol
        phase_reference()
        # slice 7: cavity-128 with rediscretized coarse levels
        redisc = phase_rediscretize(galerkin)
        # slice 2: the patch-stencil operator path
        setup = {}
        for name, problem, coarse, levels in (
                ("poisson", "poisson", PATCH_COARSE, PATCH_LEVELS),
                ("elasticity", "elasticity", ELAST_COARSE, ELAST_LEVELS)):
            t0 = time.perf_counter()
            setup[name] = patch_system(problem, coarse, levels, "cuda",
                                       torch.float32, rtol=1e-6)
            setup[name + "_s"] = time.perf_counter() - t0
        emit({"phase": "patch_setup",
              "seconds": {n: setup[n + "_s"]
                          for n in ("poisson", "elasticity")},
              "n_dofs": {n: [a.n_dofs for a in setup[n][0].assemblers]
                         for n in ("poisson", "elasticity")}})
        k2 = phase_patch_kernel(setup["poisson"][0], setup["elasticity"][0])
        main2 = phase_patch_solve(*setup["poisson"], "patch_main",
                                  setup["poisson_s"])
        if args.profile:
            psys = setup["poisson"][0]
            phase_profile(psys, torch.as_tensor(
                psys.gather(-1) * 0.0, dtype=psys.dtype, device="cuda"),
                "poisson-patch-1M")
        phase_patch_solve(*setup["elasticity"], "patch_elasticity",
                          setup["elasticity_s"])
        del setup
        phase_patch_reference()
        # slice 3: the lattice operator path and the other solver routes
        ops = phase_lattice_setup()
        k34 = phase_lattice_kernel(ops, k2)
        main3 = phase_lattice_main(ops)
        if args.profile:
            phase_lattice_profile(ops)
        del ops
        phase_lattice_reference()
        phase_cycles_reference()
        # slice 6: block solvers, norms and convergence, face forms and
        # optimal control on the BELL-frame operator
        s6 = run_slice6(args.profile)
        # slice 7: adaptive mesh refinement with multigrid across the AMR
        # levels
        s7 = run_slice7()
        # slice 8: the Boussinesq cavity (the slice's main path), the other
        # forms, surface FE, the batch-first layout, mixed-element meshes
        # and the nonlocal operator, all through kernel B1
        s8 = run_slice8()
        # slice 9: the mesh readers (a Gambit file read and refined, a
        # Poisson solve on it), Lagrangian markers, explicit MPM and
        # MPM-FSI, mesh-to-mesh projection and UQ
        s9 = run_slice9()
        # slice 10: the multi-device layer (4 ranks sharing the card, B1
        # and B2 on every rank) and the 3-D patch operator
        s10 = run_slice10()
        # slice 5: monolithic FSI on the BELL-frame operator, steady and
        # transient
        fsys, fsol, fsetup = phase_fsi_setup()
        # the FSI solve multiplies in float64 (FSI_DTYPE): that row first
        kf = phase_kernel(fsys, "fsi_kernel", (("f64", torch.float64),
                                               ("f32", torch.float32)))
        fmain = phase_fsi_main(fsys, fsol, fsetup)
        if args.profile:
            # one FGMRES cycle (60 iterations) keeps the trace short
            fsys.config.max_outer = 1
            phase_profile(fsys, torch.as_tensor(
                fsys.gather(-1), dtype=fsys.dtype, device="cuda"), "FSI")
        del fsys, fsol
        ftr = phase_fsi_transient()
        phase_fsi_reference()
        # slice 12: the golden apps (the JAX main path's builder on a
        # Turek-style channel, B1) and the ten examples
        s12 = run_slice12()
    except Exception:
        traceback.print_exc()
        return 1
    emit({"phase": "run", "seconds": time.perf_counter() - t_run})
    print(card)
    emit({"kernels": [{
        "name": "bell_spmv", "route": "cuda",
        "source": "femus_tpu_torch/algebra/csrc/sell_spmv.cu",
        "replaces": "femus_tpu/algebra/bell.py:603",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        # the same kernel on the FSI Jacobian (fsi-bed-64), main path and
        # transient drive
        "fsi_launches": fmain["kernel_launches"]["bell_spmv"],
        "fsi_transient_launches": ftr["kernel_launches"]["bell_spmv"],
        "fsi_values": "f64",
        **{"fsi_" + key: kf[key] for key in KERNEL_KEYS + ("fill",)},
        # and on the KKT operator (oc-distributed-128) and the slice-6
        # paths
        "oc_launches": s6["main"]["kernel_launches"]["bell_spmv"],
        "oc_pdas_launches": s6["pdas"]["kernel_launches"]["bell_spmv"],
        "oc_boundary_launches":
            s6["boundary"]["kernel_launches"]["bell_spmv"],
        "fieldsplit_launches":
            s6["fieldsplit"]["kernel_launches"]["bell_spmv"],
        "convergence_launches":
            s6["convergence"]["kernel_launches"]["bell_spmv"],
        **{"oc_" + key: s6["kernel"][key]
           for key in KERNEL_KEYS + ("fill",)},
        # and on the AMR reduced operators (amr-lshape, float64) and the
        # rediscretized levels (cavity-128-rediscretize)
        "amr_launches": s7["amr"]["launches"],
        "rediscretize_launches": redisc["launches"],
        "amr_values": "f64",
        **{"amr_" + key: s7["amr"][key]
           for key in KERNEL_KEYS + ("fill",)},
        # and on the slice-8 paths: the Boussinesq Jacobian
        # (boussinesq-cavity-128, float32) and the nonlocal operator
        # (nonlocal-64, float64, rows of up to 357)
        "bous_launches": s8["main"]["kernel_launches"]["bell_spmv"],
        "forms_launches": s8["forms"]["launches"],
        "surface_launches": s8["surface"]["launches"],
        "conformal_launches": s8["conformal"]["launches"],
        "mixed_launches": s8["mixed"]["launches"],
        "sw_launches": s8["sw"]["launches"],
        "nonlocal_launches": s8["nonlocal"]["launches"],
        **{"bous_" + key: s8["kernel"][key]
           for key in KERNEL_KEYS + ("fill",)},
        "nonlocal_values": "f64",
        **{"nonlocal_" + key: s8["nonlocal"][key]
           for key in KERNEL_KEYS + ("fill",)},
        # and on the slice-9 paths: Q2 Poisson on the mesh read from a
        # Gambit file (gambit-poisson-256) and ex07's collocation operator
        # (uq-pce-128), both float64
        "gambit_launches": s9["gambit"]["launches"],
        "uq_launches": s9["uq"]["launches"],
        "gambit_values": "f64", "uq_values": "f64",
        **{"gambit_" + key: s9["gambit"][key]
           for key in KERNEL_KEYS + ("fill",)},
        **{"uq_" + key: s9["uq"][key]
           for key in KERNEL_KEYS + ("fill",)},
        # and on the ranks' blocks of the multi-device layer: the halo
        # SpMV (dist_halo) and the sharded step (dist_step); the row is the
        # slowest rank's whole local product (both B1 launches) of the
        # cavity-128 Jacobian, float32, beside the CSR of the same block
        "dist_halo_launches": s10["halo"]["b1_launches"],
        "dist_step_launches": s10["step"]["b1_launches"],
        # of which the slice-11 configs (the sharded Vanka and aux-field
        # steps), and the slice-11 phases on cavity-128: profile_step's
        # solve steps, the traced step, the two checkpoint steps
        "dist_step_vanka_launches": s10["step"]["vanka_b1_launches"],
        "diagnostics_launches": s11["diagnostics"]["b1_launches"],
        "trace_launches": s11["trace"]["b1_launches"],
        "checkpoint_launches": s11["checkpoint"]["b1_launches"],
        # and on the slice-12 paths: the channel Jacobian of the JAX main
        # path's builder (ns-channel, float32) and the FSI channel
        # (fsi-channel, float64)
        "channel_launches": s12["main"]["kernel_launches"]["bell_spmv"],
        "fsi_channel_launches": s12["fsi"]["kernel_launches"]["bell_spmv"],
        "channel_values": "f32",
        **{"channel_" + key: s12["kernel"][key]
           for key in KERNEL_KEYS + ("fill",)},
        "dist_values": "f32",
        **{"dist_" + key: value for key, value in _b1_block_row(
            s10["halo"]["cases"]["cavity-128-f32"]["blocks_per_rank"],
            "f32").items()}}, {
        "name": "patch_stencil", "route": "cuda",
        "source": "femus_tpu_torch/algebra/csrc/patch_stencil.cu",
        "replaces": "femus_tpu/algebra/patchstencil.py:377",
        "launches": main2["kernel_launches"]["patch_stencil"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
        # and on the ranks' slabs of poisson-patch-1M (dist_patch): the
        # slowest slab's row, beside one CSR product of the same slab
        "dist_patch_launches": s10["patch"]["launches"],
        **{"dist_patch_" + key: s10["patch"]["row"][key]
           for key in KERNEL_KEYS}}, {
        "name": "dia_spmv", "route": "cuda",
        "source": "femus_tpu_torch/algebra/csrc/dia_spmv.cu",
        "replaces": "femus_tpu/algebra/dia.py:106",
        "launches": main3["sweep_launches"]["dia_spmv"],
        **{key: k34["dia_spmv"][key] for key in KERNEL_KEYS}}, {
        "name": "stencil_spmv", "route": "cuda",
        "source": "femus_tpu_torch/algebra/csrc/stencil_spmv.cu",
        "replaces": "femus_tpu/algebra/stencil.py:109",
        "launches": main3["cg_launches"]["stencil_spmv"],
        **{key: k34["stencil_spmv"][key] for key in KERNEL_KEYS}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
