#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``odefilters_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
paths through the front doors ``odefilters_torch.solve_ensemble``,
``odefilters_torch.sample_ensemble`` and ``odefilters_torch.ieks_ensemble``
at the headline width (FitzHugh-Nagumo, EK0(order=3) and EK1(order=3),
IBM prior, 8192 members, 500 uniform steps over (0, 20)): with EK0 the
filter + RTS smoother pair (dynamic and static diffusions), the filter with
its per-member log-likelihood and that likelihood's gradient by
``torch.autograd``, and the joint-posterior sampler; with EK1 the filter
with and without the smoother (dynamic, fixed, fixedMAP), the sampler and
the ensemble IEKS; the front door's default, the adaptive EK0 solve
with and without the smoother (8192 members over (0, 20), 20 save
intervals, abstol 1e-6, reltol 1e-4: the JAX package's
parameter-inference row); DiagonalEK1: the fixed-grid filter in each
diffusion mode and the adaptive solve with and without the smoother; and
in that adaptive setting the dense EK1 solve with and without the smoother
and the adaptive EK0 sampler; and ``odefilters_torch.ensemble_data_loglik``,
the per-candidate data likelihood and its gradient, at the JAX package's
data-likelihood rows (Lotka-Volterra, 8192 candidates, 120 steps:
full-state observations; prey only; DiagonalEK1; per-member data; dense
EK1 with full-state and per-member data); and the Kron-grid PDE solves
``odefilters_torch.solve_brusselator_ek0`` and ``solve_brusselator_ek1d``
(one trajectory of the 2-D Brusselator, N = 70, d = 9800, 1000 steps);
and the time-parallel solve ``odefilters_torch.solve_fixed_parallel``
(FitzHugh-Nagumo over (0, 20) on 16384 uniform steps: global EK1 and
windowed EK0, on the fused scan kernels). It
checks float32 against float64 on the worst
lanes, float64 against an independent high-accuracy integrator, the
float64 gradient against a finite difference, the sampler's calibration,
and times each path, each kernel and the plain versions with CUDA
events.

Phases:
  1. environment: a CUDA card, its name and power limit, TF32 off;
  2. build: nvcc, sm_90a, from ``odefilters_torch/ops/csrc``, one nvcc per
     source in parallel;
  3. pair kernels vs plain in float64 (B = 1000, not a multiple of the
     block size, T = 60 at the headline step dt = 0.04);
  4. the same in float32;
  5. the pair's path through the front door, float32 and float64, with the
     kernels' launch counts;
  6. the pair's timings at 8192 x 500 in float32, each kernel also held
     against its plain version at that shape;
  7. filter kernels vs plain in float64 at the shape of phase 3: the
     primal kernel (dynamic and each static diffusion), the gradient's
     forward, and the adjoint sweep on the plain forward's stream with
     cotangents from a numpy seed;
  8. the same in float32 (gradients reported, not held);
  9. the filter's path through the front door at 8192 x 500, float32 and
     float64: the forward solve, then ``torch.autograd.grad`` of
     ``lls.sum() + 0.1 us[:, 0].sum() + 0.01 stds.sum()`` with respect to
     ``(u0s, ps)``, with the kernels' launch counts; float32 against
     float64, the float64 gradient against central differences, the
     adjoint kernel against the plain adjoint at this length in float64,
     and the float64 filter means against DOP853;
 10. the filter at 8192 x 500 in float32: the primal kernel (each
     diffusion) and the gradient's forward held against their plain
     versions at this shape, then the timings of each kernel, the forward
     solve, forward + backward, and each plain version once;
 11. sampler kernels vs plain in float64 at the shape of phase 3 with
     S = 3 numpy normals: the filter-states kernel (its means directly,
     its stream through the plain sampler) and the sampler kernel on the
     plain stream;
 12. the same in float32;
 13. the sampler's path through ``sample_ensemble`` at 8192 x 500, S = 1
     and 8, float32 and float64, with the kernels' launch counts; the
     kernels against their plain versions at this shape (float32); zero
     normals against the pair's smoothed means of phase 5; the
     calibration of one member's posterior tiled across the 8192 lanes
     (float64); float32 against float64 on the same normals; the timings
     of each kernel, of ``sample_ensemble`` and of each plain version once;
 14. the static pair (fixed, fixedMAP, fixedMV): the forward kernel's
     static mode against its plain version at 1000 x 60 (float64,
     float32) and 8192 x 500 (float32); ``solve_ensemble`` at 8192 x 500
     with ``diffusions``, float32 against float64 on the worst lane; the
     static forward's timing;
 15. the EK1 kernels vs plain in float64 at the shape of phase 3 with
     S = 3 numpy normals: the filter kernel (its means directly, its
     stream through the plain smoother; with a linearization trajectory;
     fixed and fixedMAP with their sigma^2), the smoother and sampler
     kernels (each a group of 8 lanes a member) on the plain stream, both
     also bit for bit against their plain versions, the sampler at S = 8,
     3 and 1 (the first S of 8 numpy normals);
 16. the same in float32;
 17. the EK1 paths at 8192 x 500, float32 and float64, with the kernels'
     launch counts: ``solve_ensemble`` with EK1 in each mode (smoother or
     filter only; dynamic, fixed, fixedMAP), ``sample_ensemble`` at S = 1
     and 8, ``ieks_ensemble`` at 1 sweep (the EK1 smoothed solution
     exactly) and 3; float32 against float64 (``EK1_F32_US_LIMIT``);
     float64 smoothed and IEKS means against DOP853; zero normals through
     the sampler kernel against the smoother kernel's means on the same
     stream (exactly); the calibration of one member tiled across the
     lanes (float64);
 18. the EK1 kernels against their plain versions at 8192 x 100 (the
     first 100 of the 500 steps) in float32 (S = 8 normals from
     ``torch.randn``, and their first sample alone; the smoother and the
     sampler bit for bit), then the timings of each
     kernel at 8192 x 500, each EK1 front door, and
     each plain version once (at 100 steps); registers and spills;
 19. the three adaptive EK0 kernels against their plain versions at 1000
     members over (0, 20), 20 save intervals, abstol 1e-6, reltol 1e-4, in
     float64 and float32: the counts (nacc, nrej, failed, save points
     reached) on every member, the outputs to 1e-12 (float64) and 1e-5
     (float32) relative, bit-for-bit equality reported; the streaming
     kernel on its accepted rows and through the smoother kernel, the
     smoother kernel on the plain stream;
 20. the adaptive front doors, ``solve_ensemble(EK0(smooth=s))`` with its
     default ``adaptive=True``, at 8192 members in that setting, float32
     and float64, each run with the counts set to 0 before it and read
     after it: no failed member, nacc and nrej, the warp efficiency (mean
     attempts per member over the mean of each warp's largest), the worst
     member against DOP853 (float32 within max(5 x float64's, 1e-4)),
     float32 against float64, the accepted float32 steps that stream
     s2 = 0 (none), the stream's bytes, and the solves/s of each front door
     (median of 10 after 2 warm-ups);
 21. the three adaptive kernels against their plain versions at 8192
     members in float32 (each plain version run once), their times and
     their bounds from that run's counts;
 22. the four DiagonalEK1 kernels against their plain versions at 1000
     members in float64 and float32: the fixed-grid filter at T = 60 (dt =
     0.04) in each diffusion mode (us, stds, lls, sigma^2 at the filter's
     tolerances of phase 7), the three adaptive kernels over (0, 20) as in
     phase 19; bit-for-bit equality reported;
 23. the DiagonalEK1 front doors at 8192 members, float32 and float64,
     each run with the counts set to 0 before it and read after it:
     ``solve_ensemble(DiagonalEK1(smooth=False), adaptive=False)`` at 500
     steps in each diffusion mode (one launch, finite outputs, NaN lls and
     sigma^2 under a static one, float32 against float64 reported with
     counts, the float64 means against DOP853, the float32 dynamic door's
     time), and ``solve_ensemble(DiagonalEK1(smooth=s))`` adaptive as in
     phase 20;
 24. the DiagonalEK1 kernels against their plain versions at 8192
     members in float32 (the fixed grid at 500 steps), their times and
     their bounds;
 25. the four kernels of the adaptive dense EK1 solves and the adaptive
     EK0 sampler against their plain versions at 1000 members over
     (0, 20), 20 save intervals, abstol 1e-6, reltol 1e-4, in float64 and
     float32, bit for bit (checked, not only reported): the EK1 filter,
     stream and smoother kernels as in phase 19 (the counts equal on every
     member), the sampler kernel on the plain stream with S = 3 numpy
     normals, and zero normals through it against the smoother kernel's
     and the plain smoother's means;
 26. the front doors at 8192 members in that setting, float32 and
     float64, each run with the counts set to 0 before it and read after
     it: ``solve_ensemble(EK1(smooth=s))`` as phase 20 holds EK0's, and
     ``sample_ensemble(EK0(), adaptive=True)`` at S = 1 and 8 (one launch
     of each kernel, finite samples, zero normals through the front
     door's kernels against ``solve_ensemble(EK0())``'s smoothed means bit
     for bit, the float64 calibration of one member tiled across the
     lanes as in phase 13, the doors' times);
 27. the four kernels against their plain versions at 8192 members in
     float32 (the sampler at S = 8 with normals from ``torch.randn``; the
     EK1 smoother, a group of 8 lanes a member, bit for bit), their times,
     their bounds, and their registers and spills;
 28. the three data-likelihood kernels against their plain versions at
     1000 members, Lotka-Volterra over (0, 3), T = 40, 9 observations on
     the grid and off it, float64 and float32: dll and ll held where the
     plain version is finite and non-finite on the same members in both
     (some members' filters diverge at this step), bit-for-bit equality
     reported; the gradient's forward's state stream held bit for bit on
     the members that stay finite; the adjoint on the plain forward's stream with numpy
     cotangents and calib_grad both ways, on the members that stay finite
     (float64 at the gradient tolerances of phase 7, float32 reported);
     the members that diverge at the row's parameter spread, counted;
 29. the data likelihood through ``ensemble_data_loglik`` at the JAX
     package's data-likelihood row (8192 candidates, parameters scaled by
     U(0.8, 1.2), 120 steps, 9 observations of DOP853 truth with noise std
     0.05, on the grid and at 9 times off it), float32 and float64, each
     run with the counts set to 0 before it and read after it: launches
     1/0/0 for the primal, 0/1/1 for the gradient of sum(dll) in (u0s, ps,
     ys); finite values and gradients; float32 against float64 on the
     worst member (within 0.01 nats + 1e-3 |dll|); the float64 primal
     kernel against its plain version; the float64 adjoint against the
     plain adjoint at this shape (on the grid); the float64 gradient
     against central differences; the float32 gradients, with calib_grad
     both ways, against float64's (reported);
 30. the data-likelihood kernels against their plain versions at 8192 x 120
     in float32 (each plain version once), their times, the front door's
     candidates/s and gradient candidates/s on and off the grid, the
     kernels' bounds and registers;
 31. the three per-dimension data-likelihood kernels against their plain
     versions at 1000 members, Lotka-Volterra over (0, 3), T = 40, 3
     observations on the grid, float64 and float32, EK0 and DiagonalEK1,
     shared and per-member data, C = [[2, 0]] with scalar noise and the
     full state with noise (0.1, 0.3): the primal and the gradient's
     forward bit for bit (checked; NaN members alike), the stream bit for
     bit on the members that stay finite, the adjoint on the plain
     forward's stream with calib_grad both ways (float64 at the gradient
     tolerances of phase 7; float32 with two cotangents, seeded normals on
     (dll, ll) and on dll only, each output no farther from the float64
     run's adjoint than 4 times the plain version plus 1e-4 in relative
     norm where the plain version has a correct digit, ``PD_F32_FACTOR``);
 32. the per-dimension path through ``ensemble_data_loglik`` at the JAX
     package's rows (8192 candidates x 120 steps, 9 observations, noise
     std 0.05): prey-only observations (C = [[1, 0]], the row's gradient
     with calib_grad=False), DiagonalEK1 with full-state observations,
     and per-member observations, float32 and float64, each run with the
     counts set to 0 before it and read after it: launches 1/0/0 and
     0/1/1; shapes and finite values and gradients; float32 against
     float64 member by member within 0.01 nats + 1e-3 |dll| (the
     DiagonalEK1 row: all but at most ``PD_EK1D_OVER`` members, its
     float32 plain covariance as on the fixed grid); the float32 gradients
     against float64's with calib_grad both ways (reported, also without
     the members farthest apart); the float64 door's values equal to the
     primal kernel's; the float64 adjoint against the plain adjoint at
     this shape with calib_grad both ways (within 1e-8 of each row's
     scale, or 4 times the plain adjoint's own movement under a one-ulp
     perturbation of its stream, ``PD_F64_FACTOR``); the float64 gradient
     against central differences of sum(dll) in ps;
 33. the per-dimension kernels against their plain versions at 8192 x 120
     in float32 on the prey-only and DiagonalEK1 rows of phase 32 (each
     plain version once; the primal and the gradient's forward bit for bit;
     the adjoint as in phase 31 with the cotangent of (dll, ll) only, that
     of dll alone and per-member data held at 1000 members in phase 31),
     the prey-only and DiagonalEK1 rows' times, the doors'
     candidates/s and gradient candidates/s beside the host step table
     and the Taylor init, the kernels' bounds and registers;
 34. the three dense EK1 data-likelihood kernels against their plain
     versions at 1000 members, Lotka-Volterra over (0, 3), T = 40, 3
     observations on the grid: in float64 C = [[1, 0], [1, 1]] with noise
     (0.1, 0.2) and per-member data, the full state with noise 0.05 and
     shared data, C = [[2, 0]] with noise 0.1 and per-member data; in
     float32 the first; the primal and the gradient's forward bit for bit
     (checked; NaN members alike), the stream bit for bit on the members
     that stay finite, the adjoint on the plain forward's stream with
     calib_grad both ways (float64 at the gradient tolerances of phase 7;
     float32 as phase 31);
 35. the dense EK1 path through ``ensemble_data_loglik(ek1=True)`` at the
     JAX package's EK1 row (8192 candidates x 120 steps, 9 full-state
     observations, noise std 0.05) and with per-member observations,
     float32 and float64, each run with the counts set to 0 before it and
     read after it: launches 1/0/0 and 0/1/1 (the gradient of sum(dll)
     with calib_grad=False); shapes and finite values and gradients;
     float32 against float64 on the worst member within 0.01 nats + 1e-3
     |dll|; the float32 gradients against float64's with calib_grad both
     ways (reported); the float64 door's values equal to the primal
     kernel's; the float64 gradient against central differences of sum(dll)
     in ps;
 36. the dense EK1 kernels against their plain versions at that shape in
     float32 on the full-state row of phase 35 (each plain version once;
     the primal and the gradient's forward bit for bit; the adjoint as in
     phase 31, with the row's calib_grad=False and the cotangent of (dll,
     ll) only; that of dll alone and per-member data are held at 1000
     members in phase 34), the full-state row's times,
     the door's candidates/s and gradient candidates/s beside the host
     step table and the Taylor init, the kernels' bounds and registers;
 37. the two Kron-grid kernels (one thread per grid point, two barriers a
     step: EK0 a cooperative grid, DiagonalEK1 one thread-block cluster of
     16 CTAs, or a cooperative grid above the cluster's points) against
     their plain versions on the 2-D Brusselator at N = 37 (1369 points:
     11 blocks, the last partial), T = 200, dt = 1e-5, float64 and float32:
     us, var and ll bit for bit, one launch each; DiagonalEK1 also over 40
     steps at N = 100 and 120 (grids larger than the cluster's threads: 2
     and 4 points a thread) and at N = 160 (larger than the cluster holds:
     the cooperative kernel), each timed (float32);
 38. the Kron-grid front doors ``solve_brusselator_ek0`` and
     ``solve_brusselator_ek1d`` at the JAX package's rows (N = 70, d =
     9800, 1000 steps over (0, 0.01), save_every = 50), float32 and
     float64, each run with the counts set to 0 before it and read after
     it: one launch, shapes, finite outputs; the float64 means against
     scipy's DOP853 on an independent numpy Brusselator (rtol 1e-10,
     ``KG_DOP853_LIMIT``); float32 against float64 means at the worst point
     (``KG_F32_US_LIMIT``); float32 against float64 stds within an
     absolute limit at every saved point (``KG_F32_STD_LIMIT``: the float32
     covariance sits on its rounding floor, reported with the f32 / f64
     std ratio), the DiagonalEK1 points over it counted and held
     (``KG_EK1D_OVER``);
 39. each Kron-grid kernel against its plain version at that width in
     float32 (the plain version once; bit for bit), the kernels' and the
     doors' times and steps/s (median of 20 after 3 warm-ups), the Taylor
     init alone, the bounds, the 2000 grid barriers and the 2000 cluster
     barriers alone as latency floors, registers and spills;
 40. the three time-parallel scan kernels (at D = 8 ``tp_scan.cuh``'s
     chunk scan, a thread per chunk, and fixup, a thread per element;
     ``tp_group.cuh``'s cooperative totals scan, a group of lanes per
     total) against their plain versions, bit for bit (checked), at N =
     3000 and 16384 in float64 and float32, filtering and smoothing
     elements (EK1 on FitzHugh-Nagumo linearized along DOP853's solution),
     forward and reversed, and ``fused_associative_scan`` against the plain
     phases chained, one launch of each kernel; the same at D = 6 and 12
     (EK1(order=2) and EK1(order=5): all three group kernels, group sizes
     8 and 16) at N = 1024 and 3000, and at N = 1024 at D = 4
     (EK1(order=1)) and on synthetic elements at D = 2 and 3 (group sizes
     2 and 4), and at N = 2048 on synthetic elements at D = 18 and 32
     (group size 32: a warp per combine), and at N = 1025 on synthetic
     elements at D = 40, 64 and 96 (a CTA per combine, its workspace in
     shared memory or global; the plain totals scan's combine replayed
     from a CUDA graph);
 41. the global time-parallel door ``solve_fixed_parallel(prob,
     EK1(order=3), ts=linspace(0, 20, 16385), iterations=2)`` at the JAX
     package's time-parallel record, float64 and float32, each run with the
     counts set to 0 before it and read after it: the defaults resolved to
     the fused scan and the warm start, 4 launches of each scan kernel and
     1 of ``ek0_adaptive``; shapes, finite values; the float64 means against
     DOP853 and against the sequential fixed-grid EK1 smoother (fixed
     diffusion, one member; ``TP_DOP853_LIMIT``, ``TP_SEQ_LIMIT``); float32
     against float64 at the worst grid point (``TP_F32_LIMIT``), the
     float32 stds within ``TP_F32_STD_LIMIT`` absolute of float64's and
     both sigma^2 printed (the float32 ones are at its rounding floor at
     this N); the float32 sigma^2 over float64's at N = 512 (held within
     ``TP_S2_RTOL``) and 2048 (reported), the floor's witness; the
     kernels on the next sweep's elements bit for bit;
 42. the windowed door (``EK0(order=3)``, ``windows=16``: 1024-step
     windows, 2 sweeps each) with the same holds, 64 launches of each scan
     kernel;
 43. float32 at N = 16384: each kernel per kind against its plain version
     (once), its time (median of 20 after 3 warm-ups), its bound; the
     totals scan also at the windowed door's N = 1024 (bit for bit against
     its plain version there, and timed); the fused scan against the
     blocked scan at auto_block(N) (time and largest differences,
     reported); the global door's parts (Taylor init, warm start, one
     sweep's element build and scans, calibration) and both doors' times
     (the windowed one the median of 5 after 1 warm-up); the windowed
     door's 64 totals scans summed (from the N = 1024 times) and its 64
     launches of each scan kernel, their kernel time in one door call by
     ``torch.profiler``, with the count of launches it saw held at 64; the
     group kernels' times and bounds at D = 4, 6 and 12, and on synthetic
     elements at D = 18 and 32 (N = 16384) and D = 40, 64, 96 (N = 2048);
     registers and spills;
 44. the card's default ``solve_fixed_parallel(prob, EK1(order=2))`` (D =
     6) at N = 16384, float64 and float32, each run with the counts set to
     0 before it and read after it: the defaults resolve to the fused scan
     and the warm start, 8 launches of each scan kernel (the default 4
     sweeps) and 1 of ``ek0_adaptive``, at order 2 (min(q, 3), as in the
     JAX package); shapes, finite values; the float64 means against
     DOP853 (``TP6_DOP853``), float32 against float64; then at N = 1024
     the float64 door against the sequential fixed-grid EK1(order=2)
     smoother's plain version on the host (``TP6_SEQ``), computed in a
     process of its own that starts with phase 40 and is stopped after
     phase 44;
 45. the warm start's other orders: ``ek0_adaptive_kernel`` at q = 1 and
     2 against its plain version at 1000 members over (0, 20), 20 save
     intervals, abstol 1e-6, reltol 1e-4, float64 and float32, one launch
     at that order, the counts equal on every member, us, stds and lls
     bit for bit;
 46. the card's default ``solve_fixed_parallel(prob, EK1(order=3),
     warm_start=0)`` above D = 32: a d = 10 torch field (``tp_chain``, D =
     40) over (0, 5) on 2048 steps, float64 and float32, each run with the
     counts set to 0 before it and read after it: the defaults resolve to
     the fused scan, 4 launches of each scan kernel (a CTA per combine);
     shapes, finite values; the float64 means within ``TP40_BLOCKED`` of
     the same solve on the XLA-form scan on the card (the plain associative
     scan, ``block=0``), stds and covariances within ``TP40_STD_RTOL`` of
     their largest; float32 against float64.

The second-last line of the output names the card and its power limit;
the line before it lists the thirty-five kernels with their launches on
their path, errors, times, plain times, bounds, and the registers and
spill-store bytes ``nvcc -Xptxas -v`` reports for each one's float32
instantiation (``registers``, ``spill_stores``; the scan kernels at D = 8,
with their non-inlined combine's spills) (``bound_ms``: the
larger of the bytes each must move over 3.35 TB/s and the operations its
plain version does, counted per step under a dispatch mode, over 67
TFLOP/s of float32; H100 SXM data sheet; the adaptive kernels' operations
are counted per attempt (per smoothing step) and multiplied by the run's
attempts (accepted steps); the same for the DiagonalEK1 kernels of
phase 24 and the adaptive EK1 kernels of phase 27; the adaptive sampler's
operations are its plain version's on one member per accepted step, times
the run's accepted steps; the data-likelihood kernels' operations, both
paths, are their plain versions' on one member over this run's step
table, times the members; the dense EK1 kernels' operations are their
plain versions' on one member over a one-step table without and with an
observation, weighted by the run's steps of each kind, times the
members; the Kron-grid kernels' operations are their plain versions' per
step on the whole N = 70 grid, times the 1000 steps, and their grid
barriers' latency floor is printed beside the bound; the time-parallel
scan kernels' operations are their CUDA combine's on one element
(``tp_combine_ops``: the identity blocks' zeros skipped), times the
combines each function needs in the filter scan at N = 16384 (the totals
scan 1023, not its rounds' 9217), and their bytes the packed elements each
reads and writes once). ``max_abs_err`` is
kernel against plain at
8192 x 500: in float32 for the pair (phase 6), the primal filter and the
gradient's forward (phase 10) and the sampler's kernels (phase 13, S = 8;
the filter-states kernel's stream through the sampler kernel), in float64
for the adjoint (phase 9), in float32 for the EK1 kernels (phase 18 at
8192 x 100, S = 8; the filter kernel's means, and its stream through the
smoother kernel); and at 8192 members in float32 for the adaptive kernels (phase
21), the DiagonalEK1 kernels (phase 24, the fixed grid at 500 steps
under the dynamic diffusion) and the four kernels of phase 27; at 8192 x
120 on the grid for the data-likelihood kernels (phase 30 in float32, the
adjoint in float64 of phase 29) and the per-dimension ones (phase 33 in
float32, prey only; the adjoint with the row's calib_grad=False) and the
dense EK1 ones (phase 36 in float32, the full state; the adjoint with
calib_grad=False on the plain stream); and at N = 70 x 1000 steps in
float32 for the two Kron-grid kernels (phase 39), and at N = 16384 in
float32 on the filter elements for the three scan kernels (phase 43; their
times and plain times are the filter kind's). The samplers' times, plain times
and
bounds are those at S = 8. The EK1 launches are those of
``solve_ensemble(EK1)``
(filter, smoother) and ``sample_ensemble(EK1, S=8)`` (sampler) in
float32; the adaptive launches those of the float32 adaptive front doors
of phases 20, 23 and 26, the DiagonalEK1 filter's those of the float32
dynamic fixed-grid door of phase 23, the adaptive sampler's those of the
float32 ``sample_ensemble(EK0, adaptive=True)`` door at S = 8 of phase 26,
the data-likelihood kernels' those of the float32 on-grid primal and
gradient runs of phase 29, the per-dimension ones those of the float32
prey-only primal and gradient runs of phase 32, the dense EK1 ones those
of the float32 full-state primal and gradient runs of phase 35, the
Kron-grid ones those of the float32 doors of phase 38, the scan kernels'
those of the float32 global EK1 door of phase 41; the
per-dimension and dense EK1 adjoints' times are those of their rows'
gradients, calib_grad=False.

Tolerances. A kernel's output is held against the plain version in the
solution space: the forward kernel's stream goes through the plain
backward, the backward kernel reads the plain forward's stream, and the
smoothed means ``us`` and stds are compared. The raw stream is not held
to a relative tolerance: its diffusion and covariance entries carry the
innovation, a difference at the solver's accuracy floor, so one ulp of
rounding moves them by ~4e-7 relative in float64 and by O(1) in float32
(measured on the plain path; the kernels round differently, e.g. through
FMA contraction). Its largest scaled difference is printed.

The filter's kernels are built without FMA contraction and round op by
op as their plain versions do on the card (a division by a Python number
is a product with its reciprocal there), so their outputs (us, stds, lls and the
static sigma^2) are held directly: rtol 1e-10 / atol 1e-12 in float64,
1e-4 / 1e-6 in float32, at the check shape and at 8192 x 500. The adjoint
sweep's gradients are held in float64 at the check shape at the JAX
package's own gradient tolerances (rtol 1e-8, atol 1e-10): dps entry by
entry, each entry of dm0 against the largest |value| of its (row, dim)
over the members (a few entries are sums that cancel far below their
row's scale, where the hand adjoint's rounding order and autograd's
differ). At 8192 x 500 both are held so, each entry against its row's
scale, at the same tolerances. Float32 gradients of this likelihood
are ill-conditioned in the reference itself (benchmarks/grad_horizon.json:
3.27 relative error against float64 at 20 steps, 8.4e4 at 500), so they
are held finite and their largest relative difference is printed.

The sampler's kernels and the pair's file are built without FMA
contraction too. The filter-states kernel's means are held directly, its
stream through the sampler; the sampler's and the static pair's outputs
(samples; us, stds and sigma^2) directly, at the same tolerances. Zero
normals turn the sampler into the RTS mean recursion: its path is held
against the pair's smoothed means (``ZERO_NORMALS_LIMIT``). The
calibration holds the empirical mean of 8192 samples of one posterior
within 5 standard errors of the smoothed mean at every (t, dim), and the
empirical std within 5% of the smoothed std where that exceeds 1e-8 (the
standard error of a std estimated from 8192 samples is ~0.8%). The EK1
kernels are built without FMA contraction too and are held like the
sampler's: the filter's means, sigma^2 and filter stds directly, its
stream through the smoother, the smoother's and the sampler's outputs
directly. The DiagonalEK1 kernels are built without FMA contraction
too and are held like the filter's (fixed grid) and the adaptive EK0
kernels (adaptive). The fixed-grid DiagonalEK1 filter carries the plain
covariance, as the JAX kernel does; in float32 it cancels, so its
float32-against-float64 comparison is reported with counts, not held
(PERF.md), while the float64 means are held against DOP853.

Every phase that fails is reported; the script then exits nonzero and
prints no result. Without a CUDA card it exits nonzero at once. It never
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN, T_MAIN, TSPAN_MAIN = 8192, 500, (0.0, 20.0)
B_CHECK, T_CHECK = 1000, 60
TSPAN_CHECK = (0.0, T_CHECK * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN)
Q = 3
DEVICE = "cuda"
SOURCE = {
    "ek0_pair_fwd": "odefilters_torch/ops/csrc/ek0_pair.cu",
    "ek0_pair_bwd": "odefilters_torch/ops/csrc/ek0_pair.cu",
    "ek0_filter": "odefilters_torch/ops/csrc/ek0_filter.cu",
    "ek0_filter_grad_fwd": "odefilters_torch/ops/csrc/ek0_filter.cu",
    "ek0_filter_grad_bwd": "odefilters_torch/ops/csrc/ek0_filter.cu",
    "ek0_filter_states": "odefilters_torch/ops/csrc/ek0_sample.cu",
    "ek0_sampler": "odefilters_torch/ops/csrc/ek0_sample.cu",
    "ek1_filter_states": "odefilters_torch/ops/csrc/ek1_fused.cu",
    "ekd_smoother": "odefilters_torch/ops/csrc/ek1_fused.cu",
    "ekd_sampler": "odefilters_torch/ops/csrc/ek1_fused.cu",
    "ek0_adaptive": "odefilters_torch/ops/csrc/ek0_adaptive.cu",
    "ek0_adaptive_stream": "odefilters_torch/ops/csrc/ek0_adaptive.cu",
    "ek0_adaptive_smoother": "odefilters_torch/ops/csrc/ek0_adaptive.cu",
    "ek1d_filter": "odefilters_torch/ops/csrc/ek1d.cu",
    "ek1d_adaptive": "odefilters_torch/ops/csrc/ek1d.cu",
    "ek1d_adaptive_stream": "odefilters_torch/ops/csrc/ek1d.cu",
    "ek1d_adaptive_smoother": "odefilters_torch/ops/csrc/ek1d.cu",
    "ek0_adaptive_sampler": "odefilters_torch/ops/csrc/ek0_adaptive.cu",
    "ek1_adaptive": "odefilters_torch/ops/csrc/ek1_adaptive.cu",
    "ek1_adaptive_stream": "odefilters_torch/ops/csrc/ek1_adaptive.cu",
    "ek1_adaptive_smoother": "odefilters_torch/ops/csrc/ek1_adaptive.cu",
    "ek0_datalik": "odefilters_torch/ops/csrc/ek0_datalik.cu",
    "ek0_datalik_grad_fwd": "odefilters_torch/ops/csrc/ek0_datalik.cu",
    "ek0_datalik_grad_bwd": "odefilters_torch/ops/csrc/ek0_datalik.cu",
    "ek0_datalik_pd": "odefilters_torch/ops/csrc/ek0_datalik_pd.cu",
    "ek0_datalik_pd_grad_fwd": "odefilters_torch/ops/csrc/ek0_datalik_pd.cu",
    "ek0_datalik_pd_grad_bwd": "odefilters_torch/ops/csrc/ek0_datalik_pd.cu",
    "ek1_datalik": "odefilters_torch/ops/csrc/ek1_datalik.cu",
    "ek1_datalik_grad_fwd": "odefilters_torch/ops/csrc/ek1_datalik.cu",
    "ek1_datalik_grad_bwd": "odefilters_torch/ops/csrc/ek1_datalik.cu",
    "ek0_kron_grid": "odefilters_torch/ops/csrc/kron_grid.cu",
    "ek1d_kron_grid": "odefilters_torch/ops/csrc/kron_grid.cu",
    "tp_chunk_scan": "odefilters_torch/ops/csrc/tp_scan.cuh",
    "tp_totals_scan": "odefilters_torch/ops/csrc/tp_group.cuh",
    "tp_fixup": "odefilters_torch/ops/csrc/tp_scan.cuh",
}
REPLACES = {
    "ek0_pair_fwd": "odefilters/ops/pallas_kernels.py:3843",
    "ek0_pair_bwd": "odefilters/ops/pallas_kernels.py:4186",
    "ek0_filter": "odefilters/ops/pallas_kernels.py:360",
    "ek0_filter_grad_fwd": "odefilters/ops/pallas_kernels.py:534",
    "ek0_filter_grad_bwd": "odefilters/ops/pallas_kernels.py:586",
    "ek0_filter_states": "odefilters/ops/pallas_kernels.py:3679",
    "ek0_sampler": "odefilters/ops/pallas_kernels.py:4657",
    "ek1_filter_states": "odefilters/ops/pallas_kernels.py:5224",
    "ekd_smoother": "odefilters/ops/pallas_kernels.py:5338",
    "ekd_sampler": "odefilters/ops/pallas_kernels.py:5486",
    "ek0_adaptive": "odefilters/ops/pallas_kernels.py:6143",
    "ek0_adaptive_stream": "odefilters/ops/pallas_kernels.py:8434",
    "ek0_adaptive_smoother": "odefilters/ops/pallas_kernels.py:8660",
    "ek1d_filter": "odefilters/ops/pallas_kernels.py:8028",
    "ek1d_adaptive": "odefilters/ops/pallas_kernels.py:7609",
    "ek1d_adaptive_stream": "odefilters/ops/pallas_kernels.py:9174",
    "ek1d_adaptive_smoother": "odefilters/ops/pallas_kernels.py:9446",
    "ek0_adaptive_sampler": "odefilters/ops/pallas_kernels.py:10655",
    "ek1_adaptive": "odefilters/ops/pallas_kernels.py:7075",
    "ek1_adaptive_stream": "odefilters/ops/pallas_kernels.py:9920",
    "ek1_adaptive_smoother": "odefilters/ops/pallas_kernels.py:10209",
    "ek0_datalik": "odefilters/ops/pallas_kernels.py:1216",
    "ek0_datalik_grad_fwd": "odefilters/ops/pallas_kernels.py:1375",
    "ek0_datalik_grad_bwd": "odefilters/ops/pallas_kernels.py:1468",
    "ek0_datalik_pd": "odefilters/ops/pallas_kernels.py:2305",
    "ek0_datalik_pd_grad_fwd": "odefilters/ops/pallas_kernels.py:2660",
    "ek0_datalik_pd_grad_bwd": "odefilters/ops/pallas_kernels.py:2756",
    "ek1_datalik": "odefilters/ops/pallas_kernels.py:2521",
    "ek1_datalik_grad_fwd": "odefilters/ops/pallas_kernels.py:3087",
    "ek1_datalik_grad_bwd": "odefilters/ops/pallas_kernels.py:3147",
    "ek0_kron_grid": "odefilters/ops/pallas_kernels.py:6736",
    "ek1d_kron_grid": "odefilters/ops/pallas_kernels.py:7058",
    "tp_chunk_scan": "odefilters/parallel/pallas_scan.py:276",
    "tp_totals_scan": "odefilters/parallel/pallas_scan.py:295",
    "tp_fixup": "odefilters/parallel/pallas_scan.py:313",
}
STATIC = ("fixed", "fixedMAP", "fixedMV")
EK1_STATIC = ("fixed", "fixedMAP")
S_CHECK, S_MAIN = 3, 8
# the adaptive paths: the JAX package's parameter-inference row
# (benchmarks/run_all.py), its max_iters for the filter and the pair
TSPAN_ADA, S_ADA = (0.0, 20.0), 20
ADA_TOL = dict(abstol=1e-6, reltol=1e-4)
MAX_ITERS_FILTER, MAX_ITERS_PAIR = 20_000, 4096
# the front doors' defaults of the adaptive EK1 pair and the sampler
MAX_ITERS_EK1_PAIR, MAX_ITERS_SAMPLE = 512, 1024
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores

failures: list[str] = []
STARTED = time.perf_counter()


def say(msg: str) -> None:
    """Print ``msg``; a phase's header line also gets the seconds since the
    script started, so a run shows where its time limit goes."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - STARTED:.1f} s]"
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    say(f"   {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(B, dtype, tspan):
    """FHN problem and a perturbed ensemble: u0 + 0.1 N(0, 1), seed 0."""
    from odefilters_torch import convert, models

    prob = models.fitzhugh_nagumo(tspan=tspan, device=DEVICE, dtype=dtype)
    rng = np.random.default_rng(0)
    u0 = prob.u0.cpu().numpy()
    u0s = u0 + 0.1 * rng.standard_normal((B, u0.shape[0]))
    ps = np.broadcast_to(prob.p.cpu().numpy(), (B, prob.p.shape[0])).copy()
    u0s_t, ps_t = convert.ensemble_inputs_from_numpy(u0s, ps, device=DEVICE,
                                                     dtype=dtype)
    return prob, u0s_t, ps_t


class Pair:
    """The pair's arguments for one ensemble, and both versions of it."""

    def __init__(self, B, T, dtype, tspan):
        from odefilters_torch.ops import ek0_pair as ep
        from odefilters_torch.taylor import taylor_coefficients

        self.ep = ep
        self.prob, u0s, ps = inputs(B, dtype, tspan)
        dt = (tspan[1] - tspan[0]) / T
        m0 = torch.stack(taylor_coefficients(self.prob.f, u0s.T, ps.T,
                                             tspan[0], Q))
        At, Qt, QLt, p = ep.pair_constants(Q, dt)
        self.pinv0 = float(1.0 / p[0])
        self.m0_p = torch.as_tensor(p, dtype=dtype, device=DEVICE)[:, None, None] * m0
        self.ps = ps.T.contiguous()
        self.fwd_kw = dict(At=At, Qt=Qt, pinv0=self.pinv0,
                           pinv1=float(1.0 / p[1]), t0=tspan[0], dt=dt,
                           n_steps=T)
        self.bwd_kw = dict(nq=Q + 1, d=2, At=At, Qt=Qt, QLt=QLt,
                           pinv0=self.pinv0,
                           jitter=1e-6 if dtype == torch.float32 else 1e-12)

    def fwd_kernel(self, static=None):
        return self.ep.ek0_pair_fwd(self.prob.f, self.prob.field, self.m0_p,
                                    self.ps, static_diff=static, **self.fwd_kw)

    def fwd_plain(self, static=None):
        return self.ep.ek0_pair_fwd_plain(self.prob.f, self.m0_p, self.ps,
                                          static_diff=static, **self.fwd_kw)

    def bwd_kernel(self, st):
        return self.ep.ek0_pair_bwd(st, **self.bwd_kw)

    def bwd_plain(self, st):
        return self.ep.ek0_pair_bwd_plain(st, **self.bwd_kw)

    def solution(self, out, sig=None):
        """(us, stds) from the backward's (us | raw variance) rows, the stds
        rescaled by sqrt(sig) under a static diffusion (sig (d, B): fixedMV,
        stds (T+1, d, B))."""
        stds = self.pinv0 * torch.sqrt(torch.clamp(out[:, 2], min=0.0))
        if sig is not None:
            stds = (stds[:, None] if sig.ndim == 2 else stds) * torch.sqrt(sig)
        return out[:, :2], stds


class Sampler:
    """The sampler's arguments for one ensemble (those of `Pair`), S
    standard normals, and both versions of its two kernels. The normals are
    drawn with numpy from a seed, or, at the headline size, with
    ``torch.randn`` from a seeded generator on the card."""

    def __init__(self, B, T, dtype, tspan, S=None, numpy_normals=True):
        from odefilters_torch import convert
        from odefilters_torch.ops import ek0_sample as es

        self.es = es
        pair = Pair(B, T, dtype, tspan)
        self.f, self.field = pair.prob.f, pair.prob.field
        self.m0_p, self.ps = pair.m0_p, pair.ps
        kw = pair.fwd_kw
        At, _, QLt, _ = pair.ep.pair_constants(Q, kw["dt"])
        self.kw = dict(At=At, QLt=QLt, pinv0=kw["pinv0"], pinv1=kw["pinv1"],
                       t0=kw["t0"], dt=kw["dt"], n_steps=T)
        self.skw = dict(At=At, QLt=QLt, pinv0=kw["pinv0"], nq=Q + 1, d=2)
        self.z = None
        shape = (T + 1, S, Q + 1, 2, B)
        if S is not None and numpy_normals:
            z = np.random.default_rng(2).standard_normal(shape)
            self.z = convert.normals_from_numpy(z, device=DEVICE, dtype=dtype)
        elif S is not None:
            g = torch.Generator(device=DEVICE).manual_seed(2)
            self.z = torch.randn(shape, generator=g, dtype=dtype, device=DEVICE)

    def states_kernel(self):
        return self.es.ek0_filter_states(self.f, self.field, self.m0_p,
                                         self.ps, **self.kw)

    def states_plain(self):
        return self.es.ek0_filter_states_plain(self.f, self.m0_p, self.ps,
                                               **self.kw)

    def sampler_kernel(self, st, z=None):
        return self.es.ek0_sampler(st, self.z if z is None else z, **self.skw)

    def sampler_plain(self, st, z=None):
        return self.es.ek0_sampler_plain(st, self.z if z is None else z,
                                         **self.skw)


class Filter:
    """The filter's arguments for one ensemble (those of `Pair`), seeded
    output cotangents, and both versions of each of its three kernels."""

    def __init__(self, B, T, dtype, tspan):
        from odefilters_torch.ops import ek0_filter as ef

        self.ef = ef
        pair = Pair(B, T, dtype, tspan)
        self.f, self.field = pair.prob.f, pair.prob.field
        self.m0_p, self.ps, self.pinv0 = pair.m0_p, pair.ps, pair.pinv0
        self.kw = pair.fwd_kw
        self.bkw = {k: v for k, v in pair.fwd_kw.items() if k != "n_steps"}
        self.bkw["nq"] = Q + 1
        rng = np.random.default_rng(1)
        self.cts = [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                 device=DEVICE)
                    for shape in ((T + 1, 2, B), (T + 1, B), (B,))]

    def primal(self, static=None):
        return self.ef.ek0_filter(self.f, self.field, self.m0_p, self.ps,
                                  static_diff=static, **self.kw)

    def primal_plain(self, static=None):
        return self.ef.ek0_filter_plain(self.f, self.m0_p, self.ps,
                                        static_diff=static, **self.kw)

    def grad_fwd(self):
        return self.ef.ek0_filter_grad_fwd(self.f, self.field, self.m0_p,
                                           self.ps, **self.kw)

    def grad_fwd_plain(self):
        return self.ef.ek0_filter_fwd_stream_plain(self.f, self.m0_p, self.ps,
                                                   **self.kw)

    def grad_bwd(self, st):
        return self.ef.ek0_filter_grad_bwd(self.f, self.field, st, self.ps,
                                           *self.cts, **self.bkw)

    def grad_bwd_plain(self, st):
        return self.ef.ek0_filter_grad_bwd_plain(self.f, st, self.ps,
                                                 *self.cts, **self.bkw)

    def stds(self, var):
        """The primal's epilogue: pinv0 sqrt(max(var, 1e-30))."""
        return self.pinv0 * torch.sqrt(torch.clamp(var, min=1e-30))


class EK1Case:
    """The EK1 kernels' arguments for one ensemble (the inputs of `Pair`),
    S standard normals ``(T+1, S, D, B)`` (numpy from a seed, or
    ``torch.randn`` on the card), and both versions of each kernel."""

    def __init__(self, B, T, dtype, tspan, S=None, numpy_normals=True):
        from odefilters_torch import convert
        from odefilters_torch.ops import ek1_fused as e1

        self.e1 = e1
        pair = Pair(B, T, dtype, tspan)
        self.prob, self.m0_p, self.ps = pair.prob, pair.m0_p, pair.ps
        kw = pair.fwd_kw
        At, QLt, _, pinv0, pinv1 = e1._consts(Q, kw["dt"])
        self.pinv0 = pinv0
        self.kw = dict(At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1, t0=kw["t0"],
                       dt=kw["dt"], n_steps=T)
        self.skw = dict(At=At, QLt=QLt, pinv0=pinv0, nq=Q + 1, d=2)
        self.lay = e1.stream_layout(Q + 1, 2)
        self.z = None
        shape = (T + 1, S, 2 * (Q + 1), B)
        if S is not None and numpy_normals:
            z = np.random.default_rng(2).standard_normal(shape)
            self.z = convert.ek1_normals_from_numpy(z, device=DEVICE, dtype=dtype)
        elif S is not None:
            g = torch.Generator(device=DEVICE).manual_seed(2)
            self.z = torch.randn(shape, generator=g, dtype=dtype, device=DEVICE)

    def normals(self, S, seed):
        """S standard normals ``(T+1, S, D, B)`` from numpy with ``seed``."""
        from odefilters_torch import convert

        T1, _, D, B = self.z.shape
        z = np.random.default_rng(seed).standard_normal((T1, S, D, B))
        return convert.ek1_normals_from_numpy(z, device=DEVICE,
                                              dtype=self.z.dtype)

    def states_kernel(self, **kw):
        return self.e1.ek1_filter_states(self.prob.f, self.prob.jac,
                                         self.prob.field, self.m0_p, self.ps,
                                         **self.kw, **kw)

    def states_plain(self, **kw):
        return self.e1.ek1_filter_states_plain(self.prob.f, self.prob.jac,
                                               self.m0_p, self.ps, **self.kw,
                                               **kw)

    def smoother_kernel(self, st):
        return self.e1.ekd_smoother(st, **self.skw)

    def smoother_plain(self, st):
        return self.e1.ekd_smoother_plain(st, **self.skw)

    def sampler_kernel(self, st, z=None):
        return self.e1.ekd_sampler(st, self.z if z is None else z, **self.skw)

    def sampler_plain(self, st, z=None):
        return self.e1.ekd_sampler_plain(st, self.z if z is None else z,
                                         **self.skw)

    def means(self, st):
        return st[:, self.lay["m"]]

    def filter_solution(self, st):
        """The filter-only epilogue of ``ek1_fused_solve``: the solution
        means and per-dimension stds from the stream's mean and L rows."""
        D = 2 * (Q + 1)
        L = st[:, self.lay["L"]].reshape(st.shape[0], D, D, -1)[:, :2]
        return (self.pinv0 * st[:, :2],
                self.pinv0 * torch.sqrt(torch.sum(L ** 2, dim=2)))


def counters():
    """Every kernel wrapper, by the name the kernels line uses."""
    from odefilters_torch.ops import ek0_adaptive as ea
    from odefilters_torch.ops import ek0_adaptive_sample as eas
    from odefilters_torch.ops import ek0_datalik as ed
    from odefilters_torch.ops import ek0_datalik_pd as edp
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.ops import ek0_pair as ep
    from odefilters_torch.ops import ek0_sample as es
    from odefilters_torch.ops import ek1_adaptive as e1a
    from odefilters_torch.ops import ek1_datalik as e1dl
    from odefilters_torch.ops import ek1_fused as e1
    from odefilters_torch.ops import ek1d
    from odefilters_torch.ops import ek1d_adaptive as eda
    from odefilters_torch.ops import kron_grid as kg
    from odefilters_torch.ops import tp_scan as tps

    return {"ek0_pair_fwd": ep.ek0_pair_fwd, "ek0_pair_bwd": ep.ek0_pair_bwd,
            "ek0_filter": ef.ek0_filter,
            "ek0_filter_grad_fwd": ef.ek0_filter_grad_fwd,
            "ek0_filter_grad_bwd": ef.ek0_filter_grad_bwd,
            "ek0_filter_states": es.ek0_filter_states,
            "ek0_sampler": es.ek0_sampler,
            "ek1_filter_states": e1.ek1_filter_states,
            "ekd_smoother": e1.ekd_smoother,
            "ekd_sampler": e1.ekd_sampler,
            "ek0_adaptive": ea.ek0_adaptive,
            "ek0_adaptive_stream": ea.ek0_adaptive_stream,
            "ek0_adaptive_smoother": ea.ek0_adaptive_smoother,
            "ek1d_filter": ek1d.ek1d_filter,
            "ek1d_adaptive": eda.ek1d_adaptive,
            "ek1d_adaptive_stream": eda.ek1d_adaptive_stream,
            "ek1d_adaptive_smoother": eda.ek1d_adaptive_smoother,
            "ek0_adaptive_sampler": eas.ek0_adaptive_sampler,
            "ek1_adaptive": e1a.ek1_adaptive,
            "ek1_adaptive_stream": e1a.ek1_adaptive_stream,
            "ek1_adaptive_smoother": e1a.ek1_adaptive_smoother,
            "ek0_datalik": ed.ek0_datalik,
            "ek0_datalik_grad_fwd": ed.ek0_datalik_grad_fwd,
            "ek0_datalik_grad_bwd": ed.ek0_datalik_grad_bwd,
            "ek0_datalik_pd": edp.ek0_datalik_pd,
            "ek0_datalik_pd_grad_fwd": edp.ek0_datalik_pd_grad_fwd,
            "ek0_datalik_pd_grad_bwd": edp.ek0_datalik_pd_grad_bwd,
            "ek1_datalik": e1dl.ek1_datalik,
            "ek1_datalik_grad_fwd": e1dl.ek1_datalik_grad_fwd,
            "ek1_datalik_grad_bwd": e1dl.ek1_datalik_grad_bwd,
            "ek0_kron_grid": kg.ek0_kron_grid_solve,
            "ek1d_kron_grid": kg.ek1d_kron_grid_solve,
            "tp_chunk_scan": tps.tp_chunk_scan,
            "tp_totals_scan": tps.tp_totals_scan,
            "tp_fixup": tps.tp_fixup}


def reset_counts():
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counts(*names):
    c = counters()
    return {n: c[n].launches for n in names}


def close(name, got, ref, rtol, atol):
    """Check |got - ref| <= atol + rtol |ref| everywhere, all finite;
    returns the largest absolute difference."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    worst = float(err.max())
    viol = int((err > atol + rtol * ref.abs()).sum())
    check(finite and viol == 0,
          f"{name}: max |diff| {worst:.3e}, {viol} entries outside "
          f"rtol={rtol:g} atol={atol:g}, finite={finite}")
    return worst


def close_rows(name, got, ref, rtol, atol):
    """Check |got - ref| <= atol + rtol max |ref| everywhere, the max taken
    over the members (the last axis) at each entry's row, all finite;
    returns the largest absolute difference."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    scale = ref.abs().amax(dim=-1, keepdim=True)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    viol = int((err > atol + rtol * scale).sum())
    worst = float((err / scale.clamp(min=1e-300)).max())
    check(finite and viol == 0,
          f"{name}: max |diff| {float(err.max()):.3e}, largest |diff| / its "
          f"row's scale {worst:.3e}, {viol} entries outside rtol={rtol:g} "
          f"atol={atol:g} of their row's scale, finite={finite}")
    return float(err.max())


def once(fn):
    """``(fn(), milliseconds)`` of one call between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def report_grad(name, got, ref):
    """Float32 gradients: held finite, largest relative difference printed."""
    got, ref = got.double(), ref.double()
    finite = bool(torch.isfinite(got).all())
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())
    norm = float((got - ref).norm() / ref.norm())
    check(finite, f"{name}: finite={finite}; largest relative difference "
          f"{rel:.3e}, relative norm difference {norm:.3e} (reported, not "
          "held)")


def ops_of(call):
    """Floating-point operations of ``call()``: aten arithmetic calls,
    weighted by the elements they produce, counted under a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt",
             "log", "exp", "clamp", "clamp_min", "clamp_max", "where",
             "reciprocal", "pow", "maximum", "minimum", "eq", "ne", "gt", "lt",
             "ge", "le", "abs", "isfinite", "bitwise_and", "bitwise_or",
             "bitwise_not", "logical_not"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1].split(".")[0].rstrip("_")
            if name in arith:
                Count.n += (out if isinstance(out, torch.Tensor)
                            else out[0]).numel()
            return out

    with Count():
        call()
    return Count.n


def count_ops(make):
    """Floating-point operations a plain version does per step and member:
    `ops_of` for one member, over 2 steps less over 1 step. ``make(T)``
    sets up the inputs for T steps (uncounted) and returns the call to
    count."""
    return ops_of(make(2)) - ops_of(make(1))


def bound(nbytes, ops_per_step, B, T):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_per_step * B * T / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(B, T, dtype, S):
    """{name: (bound_ms, bound_by, operations per step and member)} of the
    ten fixed-grid kernels at (B, T), the samplers at S samples: each reads
    its inputs once and writes its outputs once."""
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.ops import ek0_pair as ep
    from odefilters_torch.ops import ek0_sample as es

    nq, d, n_p, V = Q + 1, 2, 4, 15
    V_states = es.states_width(nq, d)
    one1 = EK1Case(1, 2, dtype, (0.0, 2 * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN))
    kw1 = {k: v for k, v in one1.kw.items() if k != "n_steps"}
    V_ek1, D = one1.lay["V"], nq * d

    def ek1_stream(T1):
        return one1.e1.ek1_filter_states_plain(one1.prob.f, one1.prob.jac,
                                               one1.m0_p, one1.ps,
                                               n_steps=T1, **kw1)

    def ekd_sampler(T1):
        st = ek1_stream(T1)
        z = torch.ones((T1 + 1, S, D, 1), dtype=dtype, device=DEVICE)
        return lambda: one1.sampler_plain(st, z)

    def ekd_smoother(T1):
        st = ek1_stream(T1)
        return lambda: one1.smoother_plain(st)
    one = Filter(1, 2, dtype, (0.0, 2 * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN))
    f, m0, ps = one.f, one.m0_p, one.ps
    kw = {k: v for k, v in one.kw.items() if k != "n_steps"}
    QLt = ep.pair_constants(Q, kw["dt"])[2]
    skw = dict(At=kw["At"], QLt=QLt, pinv0=kw["pinv0"], pinv1=kw["pinv1"],
               t0=kw["t0"], dt=kw["dt"])

    def sampler(T1):
        st = es.ek0_filter_states_plain(f, m0, ps, n_steps=T1, **skw)
        z = torch.ones((T1 + 1, S, nq, d, 1), dtype=dtype, device=DEVICE)
        return lambda: es.ek0_sampler_plain(st, z, At=kw["At"], QLt=QLt,
                                            pinv0=kw["pinv0"], nq=nq, d=d)

    def pair_bwd(T1):
        st = ep.ek0_pair_fwd_plain(f, m0, ps, n_steps=T1, **kw)
        return lambda: ep.ek0_pair_bwd_plain(
            st, nq=nq, d=d, At=kw["At"], Qt=kw["Qt"], QLt=QLt,
            pinv0=kw["pinv0"], jitter=1e-6)

    def grad_bwd(T1):
        st = ef.ek0_filter_fwd_stream_plain(f, m0, ps, n_steps=T1, **kw)[3]
        cts = [torch.ones(shape, dtype=dtype, device=DEVICE)
               for shape in ((T1 + 1, d, 1), (T1 + 1, 1), (1,))]
        return lambda: ef.ek0_filter_grad_bwd_plain(f, st, ps, *cts, nq=nq,
                                                    **kw)

    ops = {
        "ek0_pair_fwd": count_ops(lambda T1: lambda: ep.ek0_pair_fwd_plain(
            f, m0, ps, n_steps=T1, **kw)),
        "ek0_pair_bwd": count_ops(pair_bwd),
        "ek0_filter": count_ops(lambda T1: lambda: ef.ek0_filter_plain(
            f, m0, ps, n_steps=T1, **kw)),
        "ek0_filter_grad_fwd": count_ops(
            lambda T1: lambda: ef.ek0_filter_fwd_stream_plain(
                f, m0, ps, n_steps=T1, **kw)),
        "ek0_filter_grad_bwd": count_ops(grad_bwd),
        "ek0_filter_states": count_ops(
            lambda T1: lambda: es.ek0_filter_states_plain(
                f, m0, ps, n_steps=T1, **skw)),
        "ek0_sampler": count_ops(sampler),
        "ek1_filter_states": count_ops(lambda T1: lambda: ek1_stream(T1)),
        "ekd_smoother": count_ops(ekd_smoother),
        "ekd_sampler": count_ops(ekd_sampler),
    }
    # elements moved: initial state and parameters, stream, per-step rows
    init, stream, rows = (nq * d + n_p) * B, (T + 1) * V * B, (T + 1) * B
    states = (T + 1) * V_states * B
    ek1_states = (T + 1) * V_ek1 * B
    elems = {
        "ek0_pair_fwd": init + stream,
        "ek0_pair_bwd": stream + rows * (d + 1),
        "ek0_filter": init + rows * (d + 1) + B,
        "ek0_filter_grad_fwd": init + rows * (d + 1) + B + stream,
        "ek0_filter_grad_bwd": stream + n_p * B + rows * (d + 1) + B + init,
        "ek0_filter_states": init + states,
        "ek0_sampler": states + rows * S * nq * d + rows * S * d,
        "ek1_filter_states": init + ek1_states,
        "ekd_smoother": ek1_states + rows * 2 * d,
        "ekd_sampler": ek1_states + rows * S * D + rows * S * d,
    }
    item = torch.tensor([], dtype=dtype).element_size()
    return {name: bound(elems[name] * item, ops[name], B, T) + (ops[name],)
            for name in ops}


def worst_lane(name, us, stds, us_ref, std_ref):
    """The worst-lane criteria: max |dus| <= 1e-4 over all (t, dim, member),
    |dstd| <= 1e-3 |std_ref| + 1e-6 on every entry, all finite. Returns
    (max |dus|, max |dstd|, worst member)."""
    dus = (us.double() - us_ref.double()).abs()
    dsd = (stds.double() - std_ref.double()).abs()
    finite = bool(torch.isfinite(us).all() and torch.isfinite(stds).all())
    e_us, e_sd = float(dus.max()), float(dsd.max())
    member = int(dus.amax(dim=(0, 1)).argmax())
    check(finite and e_us <= 1e-4, f"{name}: max |dus| {e_us:.3e} <= 1e-4, "
          f"finite={finite} (worst member {member})")
    viol = int((dsd > 1e-3 * std_ref.double().abs() + 1e-6).sum())
    check(viol == 0, f"{name}: max |dstd| {e_sd:.3e}, {viol} entries outside "
          "1e-3 |std| + 1e-6")
    return e_us, e_sd, member


def scaled_stream_diff(st, st_ref):
    """Largest stream difference scaled by each row entry's largest |value|."""
    scale = st_ref.double().abs().amax(dim=(0, 2), keepdim=True).clamp(min=1e-300)
    return float(((st.double() - st_ref.double()).abs() / scale).max())


def kernel_vs_plain(label, pair, rtol, atol):
    st_p = pair.fwd_plain()
    out_p = pair.bwd_plain(st_p)
    st_k = pair.fwd_kernel()
    out_k = pair.bwd_kernel(st_p)
    torch.cuda.synchronize()
    say(f"   stream: largest scaled |kernel - plain| "
        f"{scaled_stream_diff(st_k, st_p):.3e} (reported, not held)")
    us_p, sd_p = pair.solution(out_p)
    us_f, sd_f = pair.solution(pair.bwd_plain(st_k))
    us_b, sd_b = pair.solution(out_k)
    err_f = close(f"{label} forward kernel, us", us_f, us_p, rtol, atol)
    close(f"{label} forward kernel, stds", sd_f, sd_p, rtol, atol)
    err_b = close(f"{label} backward kernel, us", us_b, us_p, rtol, atol)
    close(f"{label} backward kernel, stds", sd_b, sd_p, rtol, atol)
    return err_f, err_b


def time_ms(fn, warmup, iters):
    """Median milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reference_solution(u0, p, ts):
    """FitzHugh-Nagumo by scipy's DOP853 at rtol = atol = 1e-12."""
    from scipy.integrate import solve_ivp

    a, b, tinv, izero = p

    def f(t, y):
        v, w = y
        return [v - v ** 3 / 3 - w + izero, tinv * (v + a - b * w)]

    sol = solve_ivp(f, (ts[0], ts[-1]), u0, method="DOP853", t_eval=ts,
                    rtol=1e-12, atol=1e-12)
    return sol.y.T          # (T+1, d)


def plain_outputs(flt):
    """The plain primal (each diffusion) and gradient's forward outputs."""
    refs = {static: flt.primal_plain(static) for static in (None,) + STATIC}
    refs["grad_fwd"] = flt.grad_fwd_plain()
    return refs


def outputs_vs_plain(label, flt, refs, rtol, atol):
    """The primal kernel (dynamic and each static diffusion) and the
    gradient's forward against the plain outputs ``refs`` on the same
    inputs. Returns each kernel's largest |kernel - plain|."""
    err = {"ek0_filter": 0.0}
    for static in (None,) + STATIC:
        got, ref = flt.primal(static), refs[static]
        torch.cuda.synchronize()
        name = f"{label} ek0_filter_kernel ({static or 'dynamic'})"
        errs = [close(f"{name}, us", got[0], ref[0], rtol, atol),
                close(f"{name}, stds", flt.stds(got[1]), flt.stds(ref[1]),
                      rtol, atol),
                close(f"{name}, lls", got[2], ref[2], rtol, atol)]
        if static:
            errs.append(close(f"{name}, sigma^2", got[3], ref[3], rtol, atol))
        err["ek0_filter"] = max(err["ek0_filter"], *errs)
    got, ref = flt.grad_fwd(), refs["grad_fwd"]
    torch.cuda.synchronize()
    name = f"{label} ek0_filter_grad_fwd_kernel"
    err["ek0_filter_grad_fwd"] = max(
        close(f"{name}, us", got[0], ref[0], rtol, atol),
        close(f"{name}, stds", got[1], ref[1], rtol, atol),
        close(f"{name}, lls", got[2], ref[2], rtol, atol))
    check(not got[1][0].any(), f"{name}: stds at t0 exactly 0")
    say(f"   {name}: stream, largest scaled |kernel - plain| "
        f"{scaled_stream_diff(got[3], ref[3]):.3e} (reported, not held)")
    return err


def filter_vs_plain(label, flt, rtol, atol, hold_grads):
    """Phases 7-8: each filter kernel against its plain version on the same
    inputs; the adjoint on the plain forward's stream."""
    refs = plain_outputs(flt)
    outputs_vs_plain(label, flt, refs, rtol, atol)
    st = refs["grad_fwd"][3]
    (dm0, dps), (dm0_p, dps_p) = flt.grad_bwd(st), flt.grad_bwd_plain(st)
    torch.cuda.synchronize()
    name = f"{label} ek0_filter_grad_bwd_kernel (on the plain stream)"
    if hold_grads:
        close(f"{name}, dps", dps, dps_p, 1e-8, 1e-10)
        close_rows(f"{name}, dm0", dm0, dm0_p, 1e-8, 1e-10)
    else:
        report_grad(f"{name}, dm0", dm0, dm0_p)
        report_grad(f"{name}, dps", dps, dps_p)


def filter_loss(sol):
    return sol.lls.sum() + 0.1 * sol.us[:, 0].sum() + 0.01 * sol.stds.sum()


def filter_path(odt, dtype):
    """Phase 9 for one dtype: the forward solve, then the gradient of
    `filter_loss` through the front door, with the launches of each run."""
    prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
    alg = odt.EK0(order=Q, smooth=False)
    names = ("ek0_filter", "ek0_filter_grad_fwd", "ek0_filter_grad_bwd")
    reset_counts()
    with torch.no_grad():
        sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN,
                                 adaptive=False)
    torch.cuda.synchronize()
    primal_counts = read_counts(*names)
    u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
    solg = odt.solve_ensemble(prob, alg, u, p, n_save=T_MAIN, adaptive=False)
    g_u, g_p = torch.autograd.grad(filter_loss(solg), (u, p))
    torch.cuda.synchronize()
    counts = read_counts(*names)
    grad_counts = {n: counts[n] - primal_counts[n] for n in names}
    label = str(dtype).replace("torch.", "")
    say(f"   {label}: launches in the forward solve {primal_counts}, in the "
        f"gradient run {grad_counts}")
    check(primal_counts["ek0_filter"] >= 1,
          f"{label}: ek0_filter_kernel launched in the forward solve")
    check(grad_counts["ek0_filter_grad_fwd"] >= 1
          and grad_counts["ek0_filter_grad_bwd"] >= 1,
          f"{label}: both gradient kernels launched in the gradient run")
    shapes = (tuple(sol.us.shape), tuple(sol.stds.shape),
              tuple(sol.lls.shape), tuple(g_u.shape), tuple(g_p.shape))
    check(shapes == ((T_MAIN + 1, 2, B_MAIN), (T_MAIN + 1, B_MAIN),
                     (B_MAIN,), (B_MAIN, 2), (B_MAIN, 4)),
          f"{label}: shapes us, stds, lls, d/du0s, d/dps = {shapes}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (sol.us, sol.stds, sol.lls, solg.us, solg.stds, solg.lls,
                  g_u, g_p))
    check(finite, f"{label}: outputs and gradients finite")
    # both forward kernels run the same step: their means and
    # log-likelihoods are the same numbers
    check(torch.equal(sol.us, solg.us) and torch.equal(sol.lls, solg.lls),
          f"{label}: the gradient's forward reproduces the forward solve's "
          "us and lls exactly")
    return counts, prob, u0s, ps, sol, (g_u, g_p)


def sampler_vs_plain(label, smp, rtol, atol):
    """Phases 11-12: the filter-states kernel against the plain filter (its
    means directly, its stream through the plain sampler) and the sampler
    kernel on the plain stream against the plain sampler."""
    st_p, st_k = smp.states_plain(), smp.states_kernel()
    torch.cuda.synchronize()
    name = f"{label} ek0_filter_states_kernel"
    close(f"{name}, means", st_k[:, :(Q + 1) * 2], st_p[:, :(Q + 1) * 2], rtol,
          atol)
    say(f"   {name}: stream, largest scaled |kernel - plain| "
        f"{scaled_stream_diff(st_k, st_p):.3e} (reported, not held)")
    us_p = smp.sampler_plain(st_p)
    close(f"{name}, samples through the plain sampler", smp.sampler_plain(st_k),
          us_p, rtol, atol)
    us_k = smp.sampler_kernel(st_p)
    torch.cuda.synchronize()
    close(f"{label} ek0_sampler_kernel on the plain stream, samples", us_k, us_p,
          rtol, atol)


def static_vs_plain(label, pair, static, rtol, atol, plain_bwd=True):
    """Phase 14: the pair's forward kernel in a static mode against its
    plain version: sigma^2 directly, the stream in the solution space
    through the backward (plain, or the kernel, already held against it,
    where ``plain_bwd`` is false), stds with the exit rescale. Returns the
    largest |kernel - plain| over us, stds and sigma^2."""
    (st_p, sig_p), (st_k, sig_k) = pair.fwd_plain(static), pair.fwd_kernel(static)
    torch.cuda.synchronize()
    bwd = pair.bwd_plain if plain_bwd else pair.bwd_kernel
    us_p, sd_p = pair.solution(bwd(st_p), sig_p)
    us_k, sd_k = pair.solution(bwd(st_k), sig_k)
    name = f"{label} ek0_pair_fwd_kernel ({static})"
    return max(close(f"{name}, sigma^2", sig_k, sig_p, rtol, atol),
               close(f"{name}, us", us_k, us_p, rtol, atol),
               close(f"{name}, stds", sd_k, sd_p, rtol, atol))


# Zero normals against the pair's smoothed means at 8192 x 500: the two
# forwards (square-root, collapsed plain covariance) round differently, and
# 500 steps amplify that through the innovation (CPU plain path, 256
# members: 2.2e-9 in float64; 60 steps: 4.2e-15). Limits: 10x the CPU
# figure in float64; in float32 the headline's us criterion.
ZERO_NORMALS_LIMIT = {torch.float64: 2.2e-8, torch.float32: 1e-4}


def sampler_path(odt, card, sol32, sol64):
    """Phase 13: ``sample_ensemble`` at 8192 x 500 with S = 1 and S_MAIN, in
    float32 and float64, with its launches; the kernels against their plain
    versions at this shape (float32); zero normals against the pair's
    smoothed means ``sol32``/``sol64`` of phase 5; the calibration of one
    member's posterior tiled across the lanes (float64); float32 against
    float64 on the same normals; then the timings. Returns the kernels'
    (ms, plain ms, max |kernel - plain|, launches in the main path's run)."""
    from odefilters_torch.ops import ek0_sample as es

    alg = odt.EK0(order=Q)
    names = ("ek0_filter_states", "ek0_sampler")
    launches = {}
    for dtype in (torch.float32, torch.float64):
        prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
        label = str(dtype).replace("torch.", "")
        for S in (1, S_MAIN):
            g = torch.Generator(device=DEVICE).manual_seed(S)
            reset_counts()
            us = odt.sample_ensemble(prob, alg, u0s, ps, generator=g,
                                     n_steps=T_MAIN, n_samples=S)
            torch.cuda.synchronize()
            counts = read_counts(*names)
            if dtype == torch.float32 and S == S_MAIN:
                launches = counts
            want = ((T_MAIN + 1, 2, B_MAIN) if S == 1
                    else (T_MAIN + 1, S, 2, B_MAIN))
            check(all(n == 1 for n in counts.values()),
                  f"{label} S={S}: launches in the run {counts}, one each")
            check(tuple(us.shape) == want and bool(torch.isfinite(us).all()),
                  f"{label} S={S}: samples {tuple(us.shape)}, finite")

    say("   the kernels vs plain at this shape, float32, S = "
        f"{S_MAIN} normals from torch.randn")
    smp = Sampler(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN, S_MAIN,
                  numpy_normals=False)
    st_p, states_plain_ms = once(smp.states_plain)
    us_pp, sampler_plain_ms = once(lambda: smp.sampler_plain(st_p))
    st_k = smp.states_kernel()
    us_kp, us_kk = smp.sampler_kernel(st_p), smp.sampler_kernel(st_k)
    torch.cuda.synchronize()
    head = f"f32 at {B_MAIN} x {T_MAIN}"
    close(f"{head} ek0_filter_states_kernel, means", st_k[:, :(Q + 1) * 2],
          st_p[:, :(Q + 1) * 2], 1e-4, 1e-6)
    err = {
        "ek0_filter_states": close(
            f"{head} ek0_filter_states_kernel, samples through the sampler "
            "kernel", us_kk, us_kp, 1e-4, 1e-6),
        "ek0_sampler": close(
            f"{head} ek0_sampler_kernel on the plain stream, samples", us_kp,
            us_pp, 1e-4, 1e-6),
    }
    del us_pp, us_kk

    for dtype, sol in ((torch.float64, sol64), (torch.float32, sol32)):
        s0 = smp if dtype == torch.float32 else Sampler(
            B_MAIN, T_MAIN, dtype, TSPAN_MAIN)
        zeros = torch.zeros((T_MAIN + 1, 1, Q + 1, 2, B_MAIN), dtype=dtype,
                            device=DEVICE)
        us0 = s0.sampler_kernel(s0.states_kernel(), zeros)[:, 0]
        torch.cuda.synchronize()
        e0 = float((us0.double() - sol.us.double()).abs().max())
        lim = ZERO_NORMALS_LIMIT[dtype]
        check(e0 <= lim, f"{str(dtype)[6:]} zero normals vs the pair's smoothed "
              f"means: max |dus| {e0:.3e} <= {lim:g}")

    # one member's posterior, tiled across the lanes: 8192 samples
    prob64, _, _ = inputs(1, torch.float64, TSPAN_MAIN)
    u0t = prob64.u0[None].expand(B_MAIN, 2).contiguous()
    pt = prob64.p[None].expand(B_MAIN, 4).contiguous()
    us = odt.sample_ensemble(prob64, alg, u0t, pt, n_steps=T_MAIN,
                             generator=torch.Generator(device=DEVICE).manual_seed(11))
    ref = odt.solve_ensemble(prob64, alg, u0t[:1], pt[:1], n_save=T_MAIN,
                             adaptive=False)
    mean_s, std_s = ref.us[:, :, 0], ref.stds[:, 0]
    se = std_s[:, None] / B_MAIN ** 0.5
    dmean = (us.mean(dim=2) - mean_s).abs()
    n_out = int((dmean >= 5.0 * se + 1e-12).sum())
    check(n_out == 0, f"calibration (f64, {B_MAIN} samples of one member): "
          f"empirical mean within 5 standard errors of the smoothed mean at "
          f"every (t, dim); {n_out} outside, largest |dmean| / se "
          f"{float((dmean / se.clamp(min=1e-300))[1:].max()):.3f}")
    mask = std_s > 1e-8
    ratio = us.std(dim=2, correction=0)[mask] / std_s[mask, None]
    worst = float((ratio - 1.0).abs().max())
    check(worst <= 0.05, f"calibration: |std ratio - 1| {worst:.4f} <= 0.05 "
          f"where the smoothed std > 1e-8 ({int(mask.sum())} times)")

    # float32 against float64 on the same normals
    z64 = torch.randn((T_MAIN + 1, S_MAIN, Q + 1, 2, B_MAIN), dtype=torch.float64,
                      device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(13))
    paths = {}
    for dtype in (torch.float64, torch.float32):
        s1 = Sampler(B_MAIN, T_MAIN, dtype, TSPAN_MAIN)
        paths[dtype] = s1.sampler_kernel(s1.states_kernel(), z64.to(dtype))
    d = (paths[torch.float32].double() - paths[torch.float64]).abs()
    del paths, z64
    worst = float(d.max())
    lane_max = d.amax(dim=(0, 1, 2))
    failing = torch.nonzero(lane_max > 1e-4).flatten().tolist()
    check(worst <= 1e-4, f"sampler f32 vs f64, same normals, S={S_MAIN}: max "
          f"|dx| {worst:.3e} <= 1e-4 on every entry; {len(failing)} lanes "
          f"outside, worst member {int(lane_max.argmax())}")
    for b in failing[:10]:
        t, s, j = np.unravel_index(int(d[..., b].argmax()), d.shape[:3])
        say(f"   lane {b}: |dx| {float(d[t, s, j, b]):.3e} at t index {t}, "
            f"sample {s}, dim {j}; smoothed std there "
            f"{float(sol64.stds[t, b]):.3e}")
    del d

    say(f"   timing, float32, B={B_MAIN}, T={T_MAIN}: CUDA events")
    say(f"   card: {card}")
    prob32, u0s32, ps32 = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    z1 = smp.z[:, :1].contiguous()
    ms = {"ek0_filter_states": time_ms(smp.states_kernel, warmup=3, iters=20),
          "ek0_sampler": time_ms(lambda: smp.sampler_kernel(st_p), warmup=3,
                                 iters=20)}
    ms_s1 = time_ms(lambda: smp.sampler_kernel(st_p, z1), warmup=3, iters=20)
    say(f"   ek0_filter_states kernel {ms['ek0_filter_states']:.4f} ms, plain "
        f"{states_plain_ms:.1f} ms")
    say(f"   ek0_sampler kernel S=1 {ms_s1:.4f} ms, S={S_MAIN} "
        f"{ms['ek0_sampler']:.4f} ms (ratio {ms['ek0_sampler'] / ms_s1:.2f}); "
        f"plain S={S_MAIN} {sampler_plain_ms:.1f} ms")
    for S in (1, S_MAIN):
        g = torch.Generator(device=DEVICE).manual_seed(3)
        s_ms = time_ms(lambda: odt.sample_ensemble(
            prob32, alg, u0s32, ps32, generator=g, n_steps=T_MAIN,
            n_samples=S), warmup=3, iters=20)
        say(f"   sample_ensemble S={S} (Taylor init + normals + both kernels): "
            f"{s_ms:.3f} ms = {B_MAIN * S / s_ms * 1e3:.0f} sample paths/s")
    plain_ms = {"ek0_filter_states": states_plain_ms,
                "ek0_sampler": sampler_plain_ms}
    return ms, plain_ms, err, launches


def static_path(odt, card):
    """Phase 14: the pair's forward kernel in each static mode against its
    plain version (1000 x 60 in float64 and float32, 8192 x 500 in float32),
    the front door at 8192 x 500 with ``diffusions``, float32 against float64
    on the worst lane, and the static forward's timing."""
    for static in STATIC:
        for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12),
                                  (torch.float32, 1e-4, 1e-6)):
            static_vs_plain(f"{str(dtype)[6:]} {B_CHECK} x {T_CHECK}",
                            Pair(B_CHECK, T_CHECK, dtype, TSPAN_CHECK), static,
                            rtol, atol)
    pair32 = Pair(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    for static in STATIC:
        static_vs_plain(f"f32 {B_MAIN} x {T_MAIN} (backward kernel)", pair32,
                        static, 1e-4, 1e-6, plain_bwd=False)
    for static in STATIC:
        alg = odt.EK0(order=Q, diffusionmodel=static)
        sols = {}
        for dtype in (torch.float32, torch.float64):
            prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
            reset_counts()
            sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN,
                                     adaptive=False)
            torch.cuda.synchronize()
            counts = read_counts("ek0_pair_fwd", "ek0_pair_bwd")
            shape = (2, B_MAIN) if static == "fixedMV" else (B_MAIN,)
            label = f"{static} {str(dtype)[6:]}"
            check(all(n == 1 for n in counts.values())
                  and tuple(sol.diffusions.shape) == shape
                  and tuple(sol.stds.shape) == (T_MAIN + 1,) + shape
                  and bool(torch.isfinite(sol.diffusions).all()),
                  f"{label}: launches {counts}, diffusions "
                  f"{tuple(sol.diffusions.shape)}, stds {tuple(sol.stds.shape)}")
            sols[dtype] = sol
        s32, s64 = sols[torch.float32], sols[torch.float64]
        worst_lane(f"{static} f32 vs f64", s32.us, s32.stds, s64.us, s64.stds)
        rel = (s32.diffusions.double() - s64.diffusions).abs() / s64.diffusions
        say(f"   {static}: sigma^2 f32 vs f64, largest relative difference "
            f"{float(rel.max()):.3e} (reported)")
    say(f"   timing of the pair's forward kernel, float32, B={B_MAIN}, "
        f"T={T_MAIN}: CUDA events; card: {card}")
    for static in (None,) + STATIC:
        f_ms = time_ms(lambda: pair32.fwd_kernel(static), warmup=3, iters=20)
        say(f"   ek0_pair_fwd ({static or 'dynamic'}) {f_ms:.4f} ms")


def ek1_vs_plain(label, c, rtol, atol):
    """Phases 15-16: the filter kernel against the plain filter (its means
    directly, its stream through the plain smoother; with a linearization
    trajectory; fixed and fixedMAP with their sigma^2), the smoother kernel
    and the sampler kernel (S = 8, 3 and 1) on the plain stream against
    their plain versions, both bit for bit."""
    st_p, st_k = c.states_plain(), c.states_kernel()
    torch.cuda.synchronize()
    name = f"{label} ek1_filter_states_kernel"
    close(f"{name}, means", c.means(st_k), c.means(st_p), rtol, atol)
    say(f"   {name}: stream, largest scaled |kernel - plain| "
        f"{scaled_stream_diff(st_k, st_p):.3e} (reported, not held)")
    st_f = c.states_kernel(smooth=False)
    torch.cuda.synchronize()
    check(torch.equal(st_f, st_k[:, :st_f.shape[1]]),
          f"{name}: the filter-only stream ({st_f.shape[1]} rows) is the "
          "smoothing stream's first rows exactly")
    us_p, sd_p = c.smoother_plain(st_p)
    us_f, sd_f = c.smoother_plain(st_k)
    close(f"{name}, us through the plain smoother", us_f, us_p, rtol, atol)
    close(f"{name}, stds through the plain smoother", sd_f, sd_p, rtol, atol)
    us_k, sd_k = c.smoother_kernel(st_p)
    torch.cuda.synchronize()
    close(f"{label} ekd_smoother_kernel on the plain stream, us", us_k, us_p,
          rtol, atol)
    close(f"{label} ekd_smoother_kernel on the plain stream, stds", sd_k, sd_p,
          rtol, atol)
    hold_smoother_bits(f"{label} ekd_smoother_kernel on the plain stream",
                       (us_k, sd_k), (us_p, sd_p))
    # the sampler at S = 8, 3 and 1 on the first S of 8 numpy normals: a
    # launch forms each step's gain and conditional factor once for all
    # its samples; the plain version's samples do not depend on one
    # another, so its first S of the 8 are its output at S
    z8 = c.normals(8, 4)
    x_p = c.sampler_plain(st_p, z8)
    for S in (8, 3, 1):
        x_k = c.sampler_kernel(st_p, z8[:, :S].contiguous())
        torch.cuda.synchronize()
        what = f"{label} ekd_sampler_kernel on the plain stream, samples (S={S})"
        close(what, x_k, x_p[:, :S], rtol, atol)
        bitwise(f"{what} against the plain version", x_k, x_p[:, :S],
                strict=True)
    lin = us_p.contiguous()
    st_lp, st_lk = c.states_plain(lin=lin), c.states_kernel(lin=lin)
    torch.cuda.synchronize()
    for what, got, ref in zip(("us", "stds"), c.filter_solution(st_lk),
                              c.filter_solution(st_lp)):
        close(f"{name} with a linearization trajectory, filter {what}", got,
              ref, rtol, atol)
    for static in EK1_STATIC:
        (st_sp, sig_p), (st_sk, sig_k) = (
            c.states_plain(static_diff=static, smooth=False),
            c.states_kernel(static_diff=static, smooth=False))
        torch.cuda.synchronize()
        close(f"{name} ({static}), sigma^2", sig_k, sig_p, rtol, atol)
        for what, got, ref in zip(("us", "stds"), c.filter_solution(st_sk),
                                  c.filter_solution(st_sp)):
            close(f"{name} ({static}), filter {what}", got, ref, rtol, atol)


def hold_smoother_bits(name, got, plain):
    """The group smoother kernel's (us, stds) bit for bit against its plain
    version on the same stream."""
    for what, g, p in zip(("us", "stds"), got, plain):
        bitwise(f"{name}, {what} against the plain version", g, p, strict=True)


# EK1 float32 against float64 at 8192 x 500: the means are held at ten
# times the CPU plain path's figure (scripts/torch_residual_census.py
# --only ek1: smoothed means 9.966e-06, stds 2.979e-07 with no entry outside
# the worst-lane criterion of phase 5, at which the smoothed stds are held).
EK1_F32_US_LIMIT = 1e-4
# The EK1 modes the front door runs: (smooth, diffusion)
EK1_MODES = [(s, m) for m in ("dynamic",) + EK1_STATIC for s in (True, False)]


def ek1_front_doors(odt, dtype):
    """Phase 17 for one dtype: ``solve_ensemble`` in each EK1 mode,
    ``sample_ensemble`` at S = 1 and S_MAIN and ``ieks_ensemble`` (1 and 3
    sweeps), each with the counts set to 0 just before and read just after.
    Returns the solutions by mode, the IEKS solution and the launches of the
    main paths' runs (the smoothed dynamic solve, the sampler at S_MAIN)."""
    names = ("ek1_filter_states", "ekd_smoother", "ekd_sampler")
    label = str(dtype)[6:]
    prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
    sols, launches = {}, {}
    grid = (T_MAIN + 1, 2, B_MAIN)
    for smooth, model in EK1_MODES:
        alg = odt.EK1(order=Q, smooth=smooth, diffusionmodel=model)
        reset_counts()
        sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN,
                                 adaptive=False)
        torch.cuda.synchronize()
        counts = read_counts(*names)
        if smooth and model == "dynamic":
            launches.update({n: counts[n] for n in names[:2]})
        static = model != "dynamic"
        ok = (counts == {"ek1_filter_states": 1, "ekd_smoother": int(smooth),
                         "ekd_sampler": 0}
              and tuple(sol.us.shape) == tuple(sol.stds.shape) == grid
              and sol.lls is None
              and (tuple(sol.diffusions.shape) == (B_MAIN,) if static
                   else sol.diffusions is None)
              and all(bool(torch.isfinite(x).all()) for x in
                      (sol.us, sol.stds) + ((sol.diffusions,) if static else ())))
        check(ok, f"{label} EK1(smooth={smooth}, {model}): launches {counts}, "
              f"us {tuple(sol.us.shape)}, stds {tuple(sol.stds.shape)}, "
              f"diffusions "
              f"{None if sol.diffusions is None else tuple(sol.diffusions.shape)}"
              ", finite")
        sols[(smooth, model)] = sol
    for S in (1, S_MAIN):
        g = torch.Generator(device=DEVICE).manual_seed(S)
        reset_counts()
        us = odt.sample_ensemble(prob, odt.EK1(order=Q), u0s, ps, generator=g,
                                 n_steps=T_MAIN, n_samples=S)
        torch.cuda.synchronize()
        counts = read_counts(*names)
        if S == S_MAIN:
            launches["ekd_sampler"] = counts["ekd_sampler"]
        want = grid if S == 1 else (T_MAIN + 1, S, 2, B_MAIN)
        check(counts == {"ek1_filter_states": 1, "ekd_smoother": 0,
                         "ekd_sampler": 1}
              and tuple(us.shape) == want and bool(torch.isfinite(us).all()),
              f"{label} sample_ensemble(EK1) S={S}: launches {counts}, "
              f"samples {tuple(us.shape)}, finite")
        del us
    ieks = {}
    for k in (1, 3):
        reset_counts()
        ieks[k] = odt.ieks_ensemble(prob, odt.IEKS(order=Q), u0s, ps,
                                    n_steps=T_MAIN, iterations=k)
        torch.cuda.synchronize()
        counts = read_counts(*names)
        check(counts == {"ek1_filter_states": k, "ekd_smoother": k,
                         "ekd_sampler": 0}
              and tuple(ieks[k].us.shape) == tuple(ieks[k].stds.shape) == grid
              and bool(torch.isfinite(ieks[k].us).all()
                       and torch.isfinite(ieks[k].stds).all()),
              f"{label} ieks_ensemble({k} sweeps): launches {counts}, finite")
    ref = sols[(True, "dynamic")]
    check(torch.equal(ieks[1].us, ref.us) and torch.equal(ieks[1].stds, ref.stds),
          f"{label} ieks_ensemble, one sweep: the EK1 smoothed solution exactly")
    say(f"   {label} ieks_ensemble: max |us(3 sweeps) - us(1 sweep)| "
        f"{float((ieks[3].us - ref.us).abs().max()):.3e} (reported)")
    return sols, ieks[3], launches


def ek1_path(odt, card):
    """Phase 17: the three EK1 front doors at 8192 x 500 in float32 and
    float64 with their launches; float32 against float64; float64 means
    against DOP853; zero normals against the smoothed means; the sampler's
    calibration. Returns the launches of the main paths' runs (float32)."""
    sols, ieks, launches = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        sols[dtype], ieks[dtype], counts = ek1_front_doors(odt, dtype)
        if dtype == torch.float32:
            launches = counts
    say(f"   launches in the main paths' runs (float32): {launches}")
    s32, s64 = sols[torch.float32], sols[torch.float64]
    worst = {}
    for mode in EK1_MODES:
        name = f"EK1(smooth={mode[0]}, {mode[1]}) f32 vs f64"
        if mode == (True, "dynamic"):
            worst[mode] = worst_lane(name, s32[mode].us, s32[mode].stds,
                                     s64[mode].us, s64[mode].stds)[2]
            continue
        dus = (s32[mode].us.double() - s64[mode].us).abs()
        dsd = (s32[mode].stds.double() - s64[mode].stds).abs()
        outside = int((dsd > 1e-3 * s64[mode].stds.abs() + 1e-6).sum())
        worst[mode] = int(dus.amax(dim=(0, 1)).argmax())
        check(float(dus.max()) <= EK1_F32_US_LIMIT,
              f"{name}: max |dus| {float(dus.max()):.3e} <= "
              f"{EK1_F32_US_LIMIT:g} (worst member {worst[mode]})")
        text = (f"max |dstd| {float(dsd.max()):.3e}, {outside} entries outside "
                "1e-3 |std| + 1e-6")
        if mode[1] != "dynamic":
            rel = (s32[mode].diffusions.double() - s64[mode].diffusions).abs()
            text += (f"; sigma^2 largest relative difference "
                     f"{float((rel / s64[mode].diffusions).max()):.3e}")
        say(f"   {name}: {text} (reported)")
    dus = float((ieks[torch.float32].us.double() - ieks[torch.float64].us)
                .abs().max())
    check(dus <= EK1_F32_US_LIMIT, f"ieks_ensemble (3 sweeps) f32 vs f64: max "
          f"|dus| {dus:.3e} <= {EK1_F32_US_LIMIT:g}")

    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    prob64, u0s64, ps64 = inputs(B_MAIN, torch.float64, TSPAN_MAIN)
    u0_np, p_np = u0s64.cpu().numpy(), ps64.cpu().numpy()
    members = sorted({0, 17, worst[(True, "dynamic")], B_MAIN - 1})
    refs = {k: reference_solution(u0_np[k], p_np[k], ts) for k in members}

    def ref_err(us):
        us = us.cpu().numpy()
        return max(float(np.abs(us[:, :, k] - refs[k]).max()) for k in members)

    for what, us in (("EK1 smoothed", s64[(True, "dynamic")].us),
                     ("IEKS (3 sweeps)", ieks[torch.float64].us)):
        e = ref_err(us)
        check(e <= 1e-5, f"f64 {what} means vs DOP853 (members {members}): "
              f"max |dus| {e:.3e} <= 1e-5")
    say(f"   f64 vs DOP853 (reported): EK1 filter means "
        f"{ref_err(s64[(False, 'dynamic')].us):.3e}, fixedMAP smoothed means "
        f"{ref_err(s64[(True, 'fixedMAP')].us):.3e}")
    del sols, ieks, s32, s64

    # zero normals: the sampler is the smoother's mean recursion over the
    # same stream, operation for operation
    for dtype in (torch.float64, torch.float32):
        c = EK1Case(B_MAIN, T_MAIN, dtype, TSPAN_MAIN)
        st = c.states_kernel()
        zeros = torch.zeros((T_MAIN + 1, 1, 2 * (Q + 1), B_MAIN), dtype=dtype,
                            device=DEVICE)
        x0 = c.sampler_kernel(st, zeros)[:, 0]
        us = c.smoother_kernel(st)[0]
        torch.cuda.synchronize()
        check(torch.equal(x0, us), f"{str(dtype)[6:]} EK1 zero normals: the "
              f"sampler kernel's path equals the smoother kernel's means "
              f"exactly (max |dus| {float((x0 - us).abs().max()):.3e})")
        del c, st

    # one member's posterior, tiled across the lanes: 8192 samples
    prob1, _, _ = inputs(1, torch.float64, TSPAN_MAIN)
    u0t = prob1.u0[None].expand(B_MAIN, 2).contiguous()
    pt = prob1.p[None].expand(B_MAIN, 4).contiguous()
    alg = odt.EK1(order=Q)
    us = odt.sample_ensemble(prob1, alg, u0t, pt, n_steps=T_MAIN,
                             generator=torch.Generator(device=DEVICE).manual_seed(11))
    ref = odt.solve_ensemble(prob1, alg, u0t[:1], pt[:1], n_save=T_MAIN,
                             adaptive=False)
    mean_s, std_s = ref.us[:, :, 0], ref.stds[:, :, 0]
    se = std_s / B_MAIN ** 0.5
    dmean = (us.mean(dim=2) - mean_s).abs()
    n_out = int((dmean >= 5.0 * se + 1e-12).sum())
    check(n_out == 0, f"EK1 calibration (f64, {B_MAIN} samples of one member): "
          f"empirical mean within 5 standard errors of the smoothed mean at "
          f"every (t, dim); {n_out} outside, largest |dmean| / se "
          f"{float((dmean / se.clamp(min=1e-300))[1:].max()):.3f}")
    mask = std_s > 1e-8
    ratio = us.std(dim=2, correction=0)[mask] / std_s[mask]
    worst_ratio = float((ratio - 1.0).abs().max())
    check(worst_ratio <= 0.05, f"EK1 calibration: |std ratio - 1| "
          f"{worst_ratio:.4f} <= 0.05 where the smoothed std > 1e-8 "
          f"({int(mask.sum())} entries)")
    return launches


# phase 18 holds the EK1 kernels against their plain versions over the
# first EK1_PLAIN_T of the T_MAIN steps (the same step, all 8192 members):
# the plain versions are Python loops over the steps, ~110 s at 500 steps
EK1_PLAIN_T = 100


def ek1_timing(odt, card, built):
    """Phase 18: the EK1 kernels against their plain versions at 8192 x
    EK1_PLAIN_T in float32 (normals from ``torch.randn``, S = S_MAIN and 1;
    the smoother and the sampler bit for bit), then the timings of each
    kernel at 8192 x 500,
    each front door and each plain version once, and the kernels' registers
    and spills. Returns the kernels' (ms, plain ms, max |kernel - plain|)."""
    t0, t1 = TSPAN_MAIN
    c = EK1Case(B_MAIN, EK1_PLAIN_T, torch.float32,
                (t0, t0 + (t1 - t0) * EK1_PLAIN_T / T_MAIN), S_MAIN,
                numpy_normals=False)
    st_p, states_plain_ms = once(c.states_plain)
    (us_pp, sd_pp), smoother_plain_ms = once(lambda: c.smoother_plain(st_p))
    x_pp, sampler_plain_ms = once(lambda: c.sampler_plain(st_p))
    st_k = c.states_kernel()
    us_kp, sd_kp = c.smoother_kernel(st_p)
    us_kk, sd_kk = c.smoother_kernel(st_k)
    x_kp = c.sampler_kernel(st_p)
    x1_kp = c.sampler_kernel(st_p, c.z[:, :1].contiguous())
    torch.cuda.synchronize()
    head = f"f32 at {B_MAIN} x {EK1_PLAIN_T}"
    hold_smoother_bits(f"{head} ekd_smoother_kernel on the plain stream",
                       (us_kp, sd_kp), (us_pp, sd_pp))
    # the plain samples do not depend on one another: its first of the
    # S_MAIN is its output at S = 1
    for S, got, ref in ((S_MAIN, x_kp, x_pp), (1, x1_kp, x_pp[:, :1])):
        bitwise(f"{head} ekd_sampler_kernel on the plain stream, samples "
                f"(S={S}) against the plain version", got, ref, strict=True)
    rtol, atol = 1e-4, 1e-6
    err = {
        "ek1_filter_states": max(
            close(f"{head} ek1_filter_states_kernel, means", c.means(st_k),
                  c.means(st_p), rtol, atol),
            close(f"{head} ek1_filter_states_kernel, us through the smoother "
                  "kernel", us_kk, us_kp, rtol, atol),
            close(f"{head} ek1_filter_states_kernel, stds through the smoother "
                  "kernel", sd_kk, sd_kp, rtol, atol)),
        "ekd_smoother": max(
            close(f"{head} ekd_smoother_kernel on the plain stream, us", us_kp,
                  us_pp, rtol, atol),
            close(f"{head} ekd_smoother_kernel on the plain stream, stds",
                  sd_kp, sd_pp, rtol, atol)),
        "ekd_sampler": close(
            f"{head} ekd_sampler_kernel on the plain stream, samples (S="
            f"{S_MAIN})", x_kp, x_pp, rtol, atol),
    }
    del x_pp, x_kp, x1_kp, us_kk, sd_kk, us_pp, sd_pp, us_kp, sd_kp
    del c, st_p, st_k

    say(f"   timing, float32, B={B_MAIN}, T={T_MAIN}: CUDA events; card: {card}")
    c = EK1Case(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN, S_MAIN,
                numpy_normals=False)
    st_p = c.states_kernel()
    us_kp = c.smoother_kernel(st_p)[0]
    z1 = c.z[:, :1].contiguous()
    ms = {"ek1_filter_states": time_ms(c.states_kernel, warmup=3, iters=20),
          "ekd_smoother": time_ms(lambda: c.smoother_kernel(st_p), warmup=3,
                                  iters=20),
          "ekd_sampler": time_ms(lambda: c.sampler_kernel(st_p), warmup=3,
                                 iters=20)}
    extra = {
        "ek1_filter_states (filter only)": lambda: c.states_kernel(smooth=False),
        "ek1_filter_states (fixedMAP, filter only)":
            lambda: c.states_kernel(static_diff="fixedMAP", smooth=False),
        "ek1_filter_states (linearization trajectory)":
            lambda: c.states_kernel(lin=us_kp),
        "ekd_sampler S=1": lambda: c.sampler_kernel(st_p, z1),
    }
    for name, k_ms in ms.items():
        say(f"   {name} kernel {k_ms:.4f} ms")
    for name, fn in extra.items():
        say(f"   {name} kernel {time_ms(fn, warmup=3, iters=20):.4f} ms")
    say(f"   plain (once, {EK1_PLAIN_T} steps): ek1_filter_states "
        f"{states_plain_ms:.1f} ms, ekd_smoother {smoother_plain_ms:.1f} ms, "
        f"ekd_sampler S={S_MAIN} {sampler_plain_ms:.1f} ms")
    del c, st_p, us_kp
    prob, u0s, ps = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    doors = {
        "solve_ensemble(EK1)": lambda: odt.solve_ensemble(
            prob, odt.EK1(order=Q), u0s, ps, n_save=T_MAIN, adaptive=False),
        "solve_ensemble(EK1(smooth=False))": lambda: odt.solve_ensemble(
            prob, odt.EK1(order=Q, smooth=False), u0s, ps, n_save=T_MAIN,
            adaptive=False),
        "solve_ensemble(EK1(diffusionmodel='fixedMAP'))":
            lambda: odt.solve_ensemble(
                prob, odt.EK1(order=Q, diffusionmodel="fixedMAP"), u0s, ps,
                n_save=T_MAIN, adaptive=False),
        "sample_ensemble(EK1) S=1": lambda: odt.sample_ensemble(
            prob, odt.EK1(order=Q), u0s, ps, generator=g, n_steps=T_MAIN),
        f"sample_ensemble(EK1) S={S_MAIN}": lambda: odt.sample_ensemble(
            prob, odt.EK1(order=Q), u0s, ps, generator=g, n_steps=T_MAIN,
            n_samples=S_MAIN),
        "ieks_ensemble(IEKS, 3 sweeps)": lambda: odt.ieks_ensemble(
            prob, odt.IEKS(order=Q), u0s, ps, n_steps=T_MAIN, iterations=3),
    }
    for name, fn in doors.items():
        d_ms = time_ms(fn, warmup=2, iters=10)
        say(f"   {name}: {d_ms:.3f} ms = {B_MAIN / d_ms * 1e3:.0f} members/s")
    plain_ms = {"ek1_filter_states": states_plain_ms,
                "ekd_smoother": smoother_plain_ms,
                "ekd_sampler": sampler_plain_ms}
    print_registers(built["log"], ("ek1_filter_states", "ekd_smoother",
                                   "ekd_sampler"), only="If")
    return ms, plain_ms, err


class AdaptiveCase:
    """The adaptive EK0 kernels' arguments for one ensemble over TSPAN_ADA
    at ADA_TOL with S_ADA save intervals (the inputs of `inputs`; Taylor
    init and initial steps as the front door makes them), and both versions
    of each of the three kernels."""

    names = ("ek0_adaptive", "ek0_adaptive_stream", "ek0_adaptive_smoother")
    alg_name = "EK0"
    per_dim_stds = False
    max_iters_pair = MAX_ITERS_PAIR

    def __init__(self, B, dtype):
        from odefilters_torch.ops import ek0_adaptive as ea

        self.ea = ea
        self.prob, self.u0s, self.ps_b = inputs(B, dtype, TSPAN_ADA)
        self.f, self.field = self.prob.f, self.prob.field
        self.m0, self.ps, self.dt0s = ea._init(self.f, self.u0s, self.ps_b,
                                               TSPAN_ADA, Q, **ADA_TOL)
        self.c_filter, self.c_pair = (
            ea.controller(Q, *TSPAN_ADA, S_ADA, dtype, max_iters=mi, **ADA_TOL)
            for mi in (MAX_ITERS_FILTER, self.max_iters_pair))
        self.args = (self.m0, self.ps, self.dt0s)

    def filter_kernel(self):
        return self.ea.ek0_adaptive(self.f, self.field, *self.args,
                                    self.c_filter)

    def filter_plain(self):
        return self.ea.ek0_adaptive_plain(self.f, *self.args, self.c_filter)

    def stream_kernel(self):
        return self.ea.ek0_adaptive_stream(self.f, self.field, *self.args,
                                           self.c_pair)

    def stream_plain(self):
        return self.ea.ek0_adaptive_stream_plain(self.f, *self.args,
                                                 self.c_pair)

    def smoother_kernel(self, st, counts):
        return self.ea.ek0_adaptive_smoother(st, counts, self.m0, self.c_pair)

    def smoother_plain(self, st, counts):
        return self.ea.ek0_adaptive_smoother_plain(st, counts, self.m0,
                                                   self.c_pair)

    def stream_width(self):
        return self.ea.stream_width(Q + 1, 2)

    def attempt_ops(self):
        """Operations of the plain attempt body for one member, and of the
        plain smoothing step on one row of ``st``."""
        ea = self.ea
        mem = ea.Members.start(self.m0, self.dt0s, self.c_pair.t0)
        live = torch.ones(1, dtype=torch.bool, device=DEVICE)
        ops_att = ops_of(lambda: ea.attempt(mem, self.ps, f=self.f,
                                            c=self.c_pair, live=live))
        return ops_att, ops_of(self.smoothing_step())

    def smoothing_step(self):
        """The plain smoothing step on the first row of this case's plain
        stream, as a call to count."""
        ea = self.ea
        st, _, _ = self.stream_plain()
        m_f, L_f, lh, s2, _ = ea._unpack(st[:1, :, :1].reshape(-1, 1), Q + 1, 2)
        return lambda: ea.smoother_step(
            m_f, L_f, m_f, L_f, lh, s2, At=ea._lists(self.c_pair.At),
            QLt=ea._lists(self.c_pair.QLt), nq=Q + 1, d=2)


class EK1DAdaptiveCase(AdaptiveCase):
    """`AdaptiveCase` for the adaptive DiagonalEK1 kernels, the Jacobian
    diagonal as the front door takes it (the diagonal of ``prob.jac``)."""

    names = ("ek1d_adaptive", "ek1d_adaptive_stream", "ek1d_adaptive_smoother")
    alg_name = "DiagonalEK1"
    per_dim_stds = True

    def __init__(self, B, dtype):
        from odefilters_torch.ops import ek1d
        from odefilters_torch.ops import ek1d_adaptive as eda

        super().__init__(B, dtype)
        self.eda = eda
        self.jd = ek1d.jac_diag_of(self.prob)

    def filter_kernel(self):
        return self.eda.ek1d_adaptive(self.f, self.jd, self.field, *self.args,
                                      self.c_filter)

    def filter_plain(self):
        return self.eda.ek1d_adaptive_plain(self.f, self.jd, *self.args,
                                            self.c_filter)

    def stream_kernel(self):
        return self.eda.ek1d_adaptive_stream(self.f, self.jd, self.field,
                                             *self.args, self.c_pair)

    def stream_plain(self):
        return self.eda.ek1d_adaptive_stream_plain(self.f, self.jd,
                                                   *self.args, self.c_pair)

    def smoother_kernel(self, st, counts):
        return self.eda.ek1d_adaptive_smoother(st, counts, self.m0,
                                               self.c_pair)

    def smoother_plain(self, st, counts):
        return self.eda.ek1d_adaptive_smoother_plain(st, counts, self.m0,
                                                     self.c_pair)

    def stream_width(self):
        return self.eda.stream_width(Q + 1, 2)

    def attempt_ops(self):
        """Operations of the plain attempt body for one member, and of the
        plain smoothing step (the EK0 smoother's step on each dimension)."""
        eda = self.eda
        mem = eda.start(self.m0, self.dt0s, self.c_pair)
        live = torch.ones(1, dtype=torch.bool, device=DEVICE)
        ops_att = ops_of(lambda: eda.attempt(mem, self.ps, f=self.f,
                                             jac_diag=self.jd, c=self.c_pair,
                                             live=live))
        return ops_att, ops_of(self.smoothing_step())

    def smoothing_step(self):
        ea, eda = self.ea, self.eda
        st, _, _ = self.stream_plain()
        rows = [ea._unpack(eda.dimension_stream(st[:1, :, :1], Q + 1, 2, j)
                           .reshape(-1, 1), Q + 1, 1) for j in range(2)]
        kw = dict(At=ea._lists(self.c_pair.At), QLt=ea._lists(self.c_pair.QLt),
                  nq=Q + 1, d=1)

        def step():
            for m_f, L_f, lh, s2, _ in rows:
                ea.smoother_step(m_f, L_f, m_f, L_f, lh, s2, **kw)
        return step


class EK1AdaptiveCase(AdaptiveCase):
    """`AdaptiveCase` for the adaptive dense EK1 kernels, the Jacobian as
    the front door takes it (``prob.jac``), the smoothed path at the front
    door's default ``max_iters`` of 512 (its rows are 75 wide)."""

    names = ("ek1_adaptive", "ek1_adaptive_stream", "ek1_adaptive_smoother")
    alg_name = "EK1"
    per_dim_stds = True
    max_iters_pair = MAX_ITERS_EK1_PAIR

    def __init__(self, B, dtype):
        from odefilters_torch.ops import ek1_adaptive as e1a

        super().__init__(B, dtype)
        self.e1a = e1a
        self.jac = self.prob.jac

    def filter_kernel(self):
        return self.e1a.ek1_adaptive(self.f, self.jac, self.field, *self.args,
                                     self.c_filter)

    def filter_plain(self):
        return self.e1a.ek1_adaptive_plain(self.f, self.jac, *self.args,
                                           self.c_filter)

    def stream_kernel(self):
        return self.e1a.ek1_adaptive_stream(self.f, self.jac, self.field,
                                            *self.args, self.c_pair)

    def stream_plain(self):
        return self.e1a.ek1_adaptive_stream_plain(self.f, self.jac,
                                                  *self.args, self.c_pair)

    def smoother_kernel(self, st, counts):
        return self.e1a.ek1_adaptive_smoother(st, counts, self.m0, self.c_pair)

    def smoother_plain(self, st, counts):
        return self.e1a.ek1_adaptive_smoother_plain(st, counts, self.m0,
                                                    self.c_pair)

    def stream_width(self):
        return self.e1a.stream_width(Q + 1, 2)

    def attempt_ops(self):
        """Operations of the plain attempt body for one member, and of the
        plain smoothing step on one row of ``st``."""
        e1a = self.e1a
        mem = e1a.start(self.m0, self.dt0s, self.c_pair)
        live = torch.ones(1, dtype=torch.bool, device=DEVICE)
        ops_att = ops_of(lambda: e1a.attempt(mem, self.ps, f=self.f,
                                             jac=self.jac, c=self.c_pair,
                                             live=live))
        return ops_att, ops_of(self.smoothing_step())

    def smoothing_step(self):
        e1a = self.e1a
        st, _, _ = self.stream_plain()
        D = 2 * (Q + 1)
        m_f, L_f, lh, s2, _ = e1a._unpack(st[:1, :, :1].reshape(-1, 1), D)
        kw = dict(Af=e1a.kron_lists(self.c_pair.At, 2),
                  QLf=e1a.kron_lists(self.c_pair.QLt, 2), nq=Q + 1, d=2)
        return lambda: e1a.smoother_step(m_f, L_f, m_f, L_f, lh, s2, **kw)


class AdaptiveSamplerCase:
    """The adaptive EK0 sampler's arguments for one ensemble over TSPAN_ADA
    at ADA_TOL (the inputs of `AdaptiveCase`, the front door's default
    ``max_iters`` of 1024 for the stream and the normals), the plain
    stream, and both versions of the sampler kernel."""

    def __init__(self, B, dtype, S, numpy_normals=True, seed=5):
        from odefilters_torch import convert
        from odefilters_torch.ops import ek0_adaptive_sample as eas

        self.eas = eas
        self.base = AdaptiveCase(B, dtype)
        ea = self.base.ea
        self.c = ea.controller(Q, *TSPAN_ADA, S_ADA, dtype,
                               max_iters=MAX_ITERS_SAMPLE, **ADA_TOL)
        self.st, _, self.cs = ea.ek0_adaptive_stream_plain(
            self.base.f, *self.base.args, self.c)
        shape = (MAX_ITERS_SAMPLE, S, Q + 1, 2, B)
        if numpy_normals:
            self.z = convert.normals_from_numpy(
                np.random.default_rng(seed).standard_normal(shape),
                device=DEVICE, dtype=dtype)
        else:
            g = torch.Generator(device=DEVICE).manual_seed(seed)
            self.z = torch.randn(shape, generator=g, dtype=dtype, device=DEVICE)

    def kernel(self, z=None):
        return self.eas.ek0_adaptive_sampler(
            self.st, self.cs, self.base.m0, self.z if z is None else z, self.c)

    def plain(self):
        return self.eas.ek0_adaptive_sampler_plain(self.st, self.cs,
                                                   self.base.m0, self.z, self.c)

    def smoothed(self):
        """The smoother kernel's means on the plain stream."""
        return self.base.ea.ek0_adaptive_smoother(self.st, self.cs,
                                                  self.base.m0, self.c)[0]


def same_counts(name, got, ref):
    """Check nacc, nrej, failed and the save points reached equal on every
    member."""
    differ = int((got != ref).any(dim=0).sum())
    check(differ == 0, f"{name}: nacc, nrej, failed and save points reached "
          f"equal on every member ({differ} differ)")


def bitwise(name, got, ref, strict=False):
    """Report whether ``got`` equals ``ref`` bit for bit; with ``strict``,
    check it."""
    n = int((got != ref).sum())
    text = f"{name}: {'bit for bit' if n == 0 else f'{n} entries differ'}"
    if strict:
        check(n == 0, text)
    else:
        say(f"   {text}")


def adaptive_vs_plain(label, case, rtol, strict=False, strict_smoother=False):
    """Phases 19, 21, 22 and 24: each adaptive kernel of ``case`` (EK0 or
    DiagonalEK1) against its plain version on the same inputs: the counts
    on every member, the outputs at ``rtol`` relative (bit-for-bit
    equality reported), the stream kernel through the smoother kernel and
    on its accepted rows directly, the smoother kernel on the plain stream.
    Returns each kernel's largest |kernel - plain| and the plain versions'
    milliseconds. ``strict``: bit-for-bit equality is checked, not only
    reported (``strict_smoother``: the smoother kernel's only)."""
    n_filter, n_stream, n_smoother = case.names
    (us_p, sd_p, ll_p, cn_p), f_ms = once(case.filter_plain)
    (st_p, ls_p, cs_p), s_ms = once(case.stream_plain)
    (usm_p, sdm_p), m_ms = once(lambda: case.smoother_plain(st_p, cs_p))
    us_k, sd_k, ll_k, cn_k = case.filter_kernel()
    st_k, ls_k, cs_k = case.stream_kernel()
    usm_kp, sdm_kp = case.smoother_kernel(st_p, cs_p)
    usm_kk, sdm_kk = case.smoother_kernel(st_k, cs_k)
    torch.cuda.synchronize()
    name = f"{label} {n_filter}_kernel"
    same_counts(name, cn_k, cn_p)
    err = {n_filter: max(close(f"{name}, us", us_k, us_p, rtol, 0.0),
                         close(f"{name}, stds", sd_k, sd_p, rtol, 0.0),
                         close(f"{name}, lls", ll_k, ll_p, rtol, 0.0))}
    for what, got, ref in (("us", us_k, us_p), ("stds", sd_k, sd_p),
                           ("lls", ll_k, ll_p)):
        bitwise(f"{name}, {what}", got, ref, strict)
    name = f"{label} {n_stream}_kernel"
    same_counts(name, cs_k, cs_p)
    valid = (torch.arange(st_p.shape[0], device=DEVICE)[:, None]
             < cs_p[0].long()[None])[:, None, :].expand(st_p.shape)
    bitwise(f"{name}, accepted rows", st_k[valid], st_p[valid], strict)
    err[n_stream] = max(
        close(f"{name}, lls", ls_k, ls_p, rtol, 0.0),
        close(f"{name}, us through the smoother kernel", usm_kk, usm_kp, rtol,
              0.0),
        close(f"{name}, stds through the smoother kernel", sdm_kk, sdm_kp,
              rtol, 0.0))
    name = f"{label} {n_smoother}_kernel on the plain stream"
    err[n_smoother] = max(
        close(f"{name}, us", usm_kp, usm_p, rtol, 0.0),
        close(f"{name}, stds", sdm_kp, sdm_p, rtol, 0.0))
    bitwise(f"{name}, us", usm_kp, usm_p, strict or strict_smoother)
    bitwise(f"{name}, stds", sdm_kp, sdm_p, strict or strict_smoother)
    return err, {n_filter: f_ms, n_stream: s_ms, n_smoother: m_ms}


_REFERENCES = {}


def reference_ensemble(u0s, ps, ts):
    """All members of a FitzHugh-Nagumo ensemble by scipy's DOP853 at
    rtol = atol = 1e-12, as one system: ``(len(ts), 2, B)``; kept for the
    next call on the same inputs."""
    from scipy.integrate import solve_ivp

    key = (u0s.tobytes(), ps.tobytes(), np.asarray(ts).tobytes())
    if key in _REFERENCES:
        return _REFERENCES[key]
    B = u0s.shape[0]
    a, b, tinv, izero = ps.T

    def f(t, y):
        v, w = y[:B], y[B:]
        return np.concatenate([v - v ** 3 / 3 - w + izero,
                               tinv * (v + a - b * w)])

    sol = solve_ivp(f, (ts[0], ts[-1]), np.concatenate([u0s[:, 0], u0s[:, 1]]),
                    method="DOP853", t_eval=ts, rtol=1e-12, atol=1e-12)
    _REFERENCES[key] = sol.y.reshape(2, B, -1).transpose(2, 0, 1)
    return _REFERENCES[key]


def warp_efficiency(attempts):
    """Mean attempts per member over the mean, across warps of 32
    consecutive members, of the warp's largest attempt count."""
    a = attempts.double()
    pad = (-a.numel()) % 32
    w = torch.cat([a, a.new_zeros(pad)]).reshape(-1, 32)
    return float(a.mean() / w.max(dim=1).values.mean())


def adaptive_path(odt, card, case_cls=AdaptiveCase):
    """Phases 20 and 23: both adaptive front doors of ``case_cls``'s
    algorithm (EK0 or DiagonalEK1) at 8192 members over TSPAN_ADA (the JAX
    package's parameter-inference row), float32 and float64, each run with
    the counts set to 0 before it and read after it; the counts, failures,
    the worst member against DOP853, float32 against float64, the accepted
    float32 steps that stream s2 = 0, the warp efficiency, and the solves/s
    of each front door. Returns the float32 launches."""
    n_filter, n_stream, n_smoother = case_cls.names
    alg_name = case_cls.alg_name

    def alg_of(smooth):
        return getattr(odt, alg_name)(order=Q, smooth=smooth)

    std_shape = ((S_ADA + 1, 2, B_MAIN) if case_cls.per_dim_stds
                 else (S_ADA + 1, B_MAIN))
    ts = np.linspace(*TSPAN_ADA, S_ADA + 1)
    doors = {"smoothed": (n_stream, n_smoother), "filter": (n_filter,)}
    launches, sols, worst = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        label = str(dtype).replace("torch.", "")
        prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_ADA)
        # each dtype's own (rounded) initial values
        ref = reference_ensemble(u0s.double().cpu().numpy(),
                                 ps.double().cpu().numpy(), ts)
        for door, names in doors.items():
            alg = alg_of(door == "smoothed")
            kw = dict(n_save=S_ADA, **ADA_TOL, max_iters=(
                case_cls.max_iters_pair if door == "smoothed"
                else MAX_ITERS_FILTER))
            reset_counts()
            sol = odt.solve_ensemble(prob, alg, u0s, ps, **kw)
            torch.cuda.synchronize()
            counts = read_counts(*names)
            if dtype == torch.float32:
                launches.update(counts)
            head = (f"{label} solve_ensemble({alg_name}"
                    f"(smooth={door == 'smoothed'}))")
            check(all(n == 1 for n in counts.values()),
                  f"{head}: launches in the run {counts}, one each")
            shapes = (tuple(sol.us.shape), tuple(sol.stds.shape))
            check(shapes == ((S_ADA + 1, 2, B_MAIN), std_shape)
                  and bool(torch.isfinite(sol.us).all())
                  and bool(torch.isfinite(sol.stds).all()),
                  f"{head}: us, stds {shapes}, finite")
            n_fail = int(sol.failed.sum())
            check(n_fail == 0, f"{head}: {n_fail} failed members")
            att = sol.nacc + sol.nrej
            err = np.abs(sol.us.double().cpu().numpy() - ref)
            member = int(err.max(axis=(0, 1)).argmax())
            worst[(dtype, door)] = float(err.max())
            say(f"   {head}: nacc mean {float(sol.nacc.double().mean()):.2f} "
                f"max {int(sol.nacc.max())}, nrej mean "
                f"{float(sol.nrej.double().mean()):.2f} max "
                f"{int(sol.nrej.max())}; warp efficiency "
                f"{warp_efficiency(att):.4f}; worst member {member} vs DOP853 "
                f"{worst[(dtype, door)]:.3e}")
            sols[(dtype, door)] = sol
    for door in doors:
        e32, e64 = worst[(torch.float32, door)], worst[(torch.float64, door)]
        lim = max(5 * e64, 1e-4)
        check(e32 <= lim, f"{alg_name} {door}: float32 worst member vs DOP853 "
              f"{e32:.3e} <= max(5 x float64's {e64:.3e}, 1e-4) = {lim:.3e}")
        a, b = sols[(torch.float32, door)], sols[(torch.float64, door)]
        d = (a.us.double() - b.us).abs()
        say(f"   {alg_name} {door}: float32 vs float64 means max |dus| "
            f"{float(d.max()):.3e} (member {int(d.amax(dim=(0, 1)).argmax())}); "
            f"members whose counts differ "
            f"{int(((a.nacc != b.nacc) | (a.nrej != b.nrej)).sum())}")
    del sols
    # the accepted float32 steps that stream s2 = 0 (a singular factor for
    # the smoother)
    case = case_cls(B_MAIN, torch.float32)
    st, _, cs = case.stream_kernel()
    n = cs[0].long()
    rows = torch.arange(st.shape[0], device=DEVICE)[:, None] < n[None]
    s2_col = case.stream_width() - 2      # [m | L | lh | s2 | save]
    zeros = int((st[:, s2_col][rows] == 0).sum())
    check(zeros == 0, f"{alg_name} float32: {zeros} of {int(n.sum())} "
          "accepted steps stream s2 = 0")
    stream_mb = int(n.sum()) * st.shape[1] * st.element_size() / 1e6
    say(f"   float32 stream: {int(n.sum())} accepted rows of {st.shape[1]} "
        f"values written, {stream_mb:.1f} MB (allocated "
        f"{st.numel() * st.element_size() / 1e6:.1f} MB)")
    del st, case
    torch.cuda.empty_cache()
    say(f"   timing: median of 10 after 2 warm-ups, CUDA events; card: {card}")
    for dtype in (torch.float32, torch.float64):
        prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_ADA)
        for door in doors:
            alg = alg_of(door == "smoothed")
            kw = dict(n_save=S_ADA, **ADA_TOL, max_iters=(
                case_cls.max_iters_pair if door == "smoothed"
                else MAX_ITERS_FILTER))
            d_ms = time_ms(lambda: odt.solve_ensemble(prob, alg, u0s, ps, **kw),
                           warmup=2, iters=10)
            say(f"   {str(dtype)[6:]} solve_ensemble({alg_name}, adaptive, "
                f"{door}): {d_ms:.3f} ms = {B_MAIN / d_ms * 1e3:.0f} solves/s")
        torch.cuda.empty_cache()
    return launches


def adaptive_sampler_vs_plain(label, smp, rtol):
    """Phases 25 and 27: the adaptive sampler kernel on the plain stream
    against its plain version with the case's normals (bit for bit, and at
    ``rtol``); then zero normals through the kernel (two samples) against
    the smoother kernel's and the plain smoother's means on the same
    stream, bit for bit. Returns the largest |kernel - plain| and the
    plain version's milliseconds."""
    ea = smp.base.ea
    ref, p_ms = once(smp.plain)
    got = smp.kernel()
    torch.cuda.synchronize()
    S = smp.z.shape[1]
    name = f"{label} ek0_adaptive_sampler_kernel on the plain stream"
    err = close(f"{name}, samples (S={S})", got, ref, rtol, 0.0)
    bitwise(f"{name}, samples (S={S})", got, ref, strict=True)
    del got, ref
    x0 = smp.kernel(z=torch.zeros_like(smp.z[:, :1]).expand(
        -1, 2, -1, -1, -1).contiguous())
    us_k = smp.smoothed()
    us_p = ea.ek0_adaptive_smoother_plain(smp.st, smp.cs, smp.base.m0,
                                          smp.c)[0]
    torch.cuda.synchronize()
    for what, us in (("smoother kernel's", us_k), ("plain smoother's", us_p)):
        bitwise(f"{label} zero normals through the sampler kernel (2 samples) "
                f"vs the {what} means", x0, us[:, None].expand_as(x0),
                strict=True)
    return err, p_ms


def print_registers(log, names, only=""):
    """The registers and spills that ``nvcc -Xptxas -v`` reported for the
    kernels ``names`` (each instantiation whose mangled name holds
    ``only``)."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = next((n for n in names if f"{n}_kernel" in line
                          and only in line), None)
            if entry:
                say(f"   {entry}: {line.split('function')[1].strip()}")
        elif entry and ("registers" in line or "spill" in line):
            say(f"     {line.split('ptxas info    :')[-1].strip()}")


def ptxas_usage(log):
    """``{mangled name: {"registers": n, "spill_stores": bytes}}`` from the
    ``nvcc -Xptxas -v`` log: registers of each entry function, spill stores
    of each function (entries and the non-inlined functions they call)."""
    use, fn, entry = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = entry = line.split("'")[1]
            use.setdefault(fn, {})
        elif "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip().rstrip(":")
            use.setdefault(fn, {})
        elif fn and "spill stores" in line:
            use[fn]["spill_stores"] = int(line.split("bytes spill stores")[0]
                                          .split(",")[-1])
        elif entry and "Used" in line and "registers" in line:
            use[entry]["registers"] = int(line.split("Used")[1].split()[0])
    return use


# The float32 instantiation each entry of the kernels line reports, as a
# substring of its mangled name (the first match); for the scan kernels
# also their non-inlined combine, whose spills count as theirs. The scan
# kernels at D = 8: the one-thread chunk scan and fixup, the group totals
# scan (8 lanes a total, D known at compile time).
KERNEL_SYMBOL = {
    # the main path's instantiations: the sampler at 8 samples a launch
    # (float, NQ = 4, DIM = 2, 32 members a CTA, SC = 8), the adaptive EK0
    # filter at q = 3
    "ekd_sampler": ("ekd_sampler_kernelIfLi4ELi2ELi32ELi8E", None),
    "ek0_adaptive": ("ek0_adaptive_kernelIfLi4E", None),
    "ek1d_kron_grid": ("ek1d_kron_cluster_kernelIfLi4EN4kron15BrusselatorGridIfEELi1E",
                       None),
    "tp_chunk_scan": ("tp_chunk_scan_kernelIfNS_10FilterKind",
                      "_ZN2tp14filter_combineIfLi8E"),
    "tp_totals_scan": ("tp_totals_scan_group_kernelIfLi8ELb1ELi8E",
                       "_ZN3tpg14filter_combineIfLi8ELi8E"),
    "tp_fixup": ("tp_fixup_kernelIfNS_10FilterKind",
                 "_ZN2tp14filter_combineIfLi8E"),
}


def kernel_usage(use, name):
    """The registers and spill-store bytes of the kernels line's kernel
    ``name`` (its float32 instantiation; None where the log has none)."""
    entry, callee = KERNEL_SYMBOL.get(name, (f"{name}_kernelIf", None))
    hit = next((k for k in use if entry in k and "registers" in use[k]), None)
    if hit is None:
        return None, None
    spills = use[hit].get("spill_stores", 0)
    if callee:
        spills = max([spills] + [v.get("spill_stores", 0)
                                 for k, v in use.items() if callee in k])
    return use[hit]["registers"], spills


def adaptive_sampler_path(odt, card):
    """Phase 26, the sampler: ``sample_ensemble(EK0(), adaptive=True)`` at
    8192 members over TSPAN_ADA (S_ADA save intervals, ADA_TOL) with S = 1
    and S_MAIN, float32 and float64, each run with the counts set to 0
    before it and read after it: one launch of each kernel, shapes, finite
    samples; zero normals through the front door's kernels against
    ``solve_ensemble(EK0())``'s smoothed means (bit for bit); the float64
    calibration of one member tiled across the lanes; the doors' times.
    Returns the float32 S_MAIN run's launches."""
    from odefilters_torch.ops import ek0_adaptive as ea
    from odefilters_torch.ops import ek0_adaptive_sample as eas

    alg = odt.EK0(order=Q)
    names = ("ek0_adaptive_stream", "ek0_adaptive_sampler")
    kw = dict(n_steps=S_ADA, adaptive=True, max_iters=MAX_ITERS_SAMPLE,
              **ADA_TOL)
    launches = {}
    for dtype in (torch.float32, torch.float64):
        label = str(dtype).replace("torch.", "")
        prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_ADA)
        for S in (1, S_MAIN):
            g = torch.Generator(device=DEVICE).manual_seed(S)
            reset_counts()
            us = odt.sample_ensemble(prob, alg, u0s, ps, generator=g,
                                     n_samples=S, **kw)
            torch.cuda.synchronize()
            counts = read_counts(*names)
            if dtype == torch.float32 and S == S_MAIN:
                launches = counts
            want = ((S_ADA + 1, 2, B_MAIN) if S == 1
                    else (S_ADA + 1, S, 2, B_MAIN))
            head = f"{label} sample_ensemble(EK0, adaptive) S={S}"
            check(all(n == 1 for n in counts.values()),
                  f"{head}: launches in the run {counts}, one each")
            check(tuple(us.shape) == want and bool(torch.isfinite(us).all()),
                  f"{head}: samples {tuple(us.shape)}, finite")
            del us
        # zero normals through the front door's kernels: the smoothed means
        sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=S_ADA,
                                 max_iters=MAX_ITERS_SAMPLE, **ADA_TOL)
        m0, ps_t, dt0s = ea._init(prob.f, u0s, ps, TSPAN_ADA, Q, **ADA_TOL)
        zeros = torch.zeros((MAX_ITERS_SAMPLE, 1, Q + 1, 2, B_MAIN),
                            dtype=dtype, device=DEVICE)
        x0 = eas.ek0_adaptive_fused_sample(
            prob.f, m0, ps_t, dt0s, zeros, *TSPAN_ADA, S_ADA, Q,
            max_iters=MAX_ITERS_SAMPLE, field=prob.field, **ADA_TOL)[0]
        torch.cuda.synchronize()
        bitwise(f"{label} zero normals vs solve_ensemble(EK0())'s smoothed "
                f"means at {B_MAIN}", x0[:, 0], sol.us, strict=True)
        del x0, zeros, sol
    # one member's posterior, tiled across the lanes: 8192 samples
    prob64, _, _ = inputs(1, torch.float64, TSPAN_ADA)
    u0t = prob64.u0[None].expand(B_MAIN, 2).contiguous()
    pt = prob64.p[None].expand(B_MAIN, 4).contiguous()
    us = odt.sample_ensemble(
        prob64, alg, u0t, pt,
        generator=torch.Generator(device=DEVICE).manual_seed(11), **kw)
    ref = odt.solve_ensemble(prob64, alg, u0t[:1], pt[:1], n_save=S_ADA,
                             max_iters=MAX_ITERS_SAMPLE, **ADA_TOL)
    mean_s, std_s = ref.us[:, :, 0], ref.stds[:, 0]
    se = std_s[:, None] / B_MAIN ** 0.5
    dmean = (us.mean(dim=2) - mean_s).abs()
    n_out = int((dmean >= 5.0 * se + 1e-12).sum())
    check(n_out == 0, f"adaptive calibration (f64, {B_MAIN} samples of one "
          f"member): empirical mean within 5 standard errors of the smoothed "
          f"mean at every (save point, dim); {n_out} outside, largest "
          f"|dmean| / se {float((dmean / se.clamp(min=1e-300))[1:].max()):.3f}")
    mask = std_s > 1e-8
    ratio = us.std(dim=2, correction=0)[mask] / std_s[mask, None]
    worst = float((ratio - 1.0).abs().max())
    check(worst <= 0.05, f"adaptive calibration: |std ratio - 1| {worst:.4f} "
          f"<= 0.05 where the smoothed std > 1e-8 ({int(mask.sum())} save "
          "points)")
    del us
    say(f"   timing: median of 10 after 2 warm-ups, CUDA events; card: {card}")
    prob, u0s, ps = inputs(B_MAIN, torch.float32, TSPAN_ADA)
    for S in (1, S_MAIN):
        g = torch.Generator(device=DEVICE).manual_seed(3)
        d_ms = time_ms(lambda: odt.sample_ensemble(
            prob, alg, u0s, ps, generator=g, n_samples=S, **kw),
            warmup=2, iters=10)
        say(f"   float32 sample_ensemble(EK0, adaptive) S={S}: {d_ms:.3f} ms "
            f"= {B_MAIN * S / d_ms * 1e3:.0f} sample paths/s")
    torch.cuda.empty_cache()
    return launches


def adaptive_sampler_timing(card):
    """Phase 27, the sampler: the kernel against its plain version at 8192
    members in float32 with S_MAIN normals from ``torch.randn`` (the plain
    version once), its time at S = 1 and S_MAIN, and its bound from this
    run's accepted steps. Returns (ms, plain ms, max |kernel - plain|,
    (bound_ms, bound_by, operations per accepted step and member))."""
    smp = AdaptiveSamplerCase(B_MAIN, torch.float32, S_MAIN,
                              numpy_normals=False)
    err, plain_ms = adaptive_sampler_vs_plain(f"f32 at {B_MAIN}", smp, 1e-5)
    ms = time_ms(smp.kernel, warmup=3, iters=20)
    z1 = smp.z[:, :1].contiguous()
    ms1 = time_ms(lambda: smp.kernel(z=z1), warmup=3, iters=20)
    say(f"   ek0_adaptive_sampler kernel S=1 {ms1:.4f} ms, S={S_MAIN} "
        f"{ms:.4f} ms; plain (once) S={S_MAIN} {plain_ms:.1f} ms "
        f"(card: {card})")
    # operations: the plain sampler on one member of this ensemble, per
    # accepted step; bytes: the accepted rows and their normals read once,
    # the initial means and counts read, the samples written once
    one = AdaptiveSamplerCase(1, torch.float32, S_MAIN, numpy_normals=False)
    ops = ops_of(one.plain) / max(int(one.cs[0, 0]), 1)
    acc = int(smp.cs[0].sum())
    item = 4
    nbytes = (acc * (smp.st.shape[1] + S_MAIN * (Q + 1) * 2) * item
              + smp.base.ea.N_COUNTS * B_MAIN * 4 + (Q + 1) * 2 * B_MAIN * item
              + (S_ADA + 1) * S_MAIN * 2 * B_MAIN * item)
    b = bound(nbytes, ops, 1, acc)
    say(f"   ek0_adaptive_sampler: {ops:.0f} operations per accepted step "
        f"and member at S={S_MAIN} ({acc} accepted steps); "
        f"{nbytes / 1e6:.1f} MB; bound {b[0]:.4f} ms by {b[1]}")
    del smp
    torch.cuda.empty_cache()
    return ms, plain_ms, err, b + (ops,)


def adaptive_timing(card, case_cls=AdaptiveCase, strict_smoother=False):
    """Phases 21, 24 and 27: the three adaptive kernels of ``case_cls``
    against their plain versions at 8192 members in float32 (each plain
    version run once; with ``strict_smoother`` the smoother kernel bit for
    bit), then each kernel's time and its bound from this run's counts.
    Returns (ms, plain ms, max |kernel - plain|, {name: (bound_ms, bound_by,
    ops per unit)})."""
    n_filter, n_stream, n_smoother = case_cls.names
    case = case_cls(B_MAIN, torch.float32)
    err, plain_ms = adaptive_vs_plain(f"f32 at {B_MAIN}", case, 1e-5,
                                      strict_smoother=strict_smoother)
    us, sd, _, cn = case.filter_kernel()
    st, _, cs = case.stream_kernel()
    torch.cuda.synchronize()
    say(f"   timing, float32, B={B_MAIN}: CUDA events; card: {card}")
    ms = {n_filter: time_ms(case.filter_kernel, warmup=3, iters=20),
          n_stream: time_ms(case.stream_kernel, warmup=3, iters=20),
          n_smoother: time_ms(lambda: case.smoother_kernel(st, cs), warmup=3,
                              iters=20)}
    for name in ms:
        say(f"   {name} kernel {ms[name]:.4f} ms, plain (once) "
            f"{plain_ms[name]:.1f} ms")
    # operations: the plain attempt body per attempt and member and the
    # plain smoother step per accepted step but the last, each counted for
    # one member of this ensemble
    ops_att, ops_step = case_cls(1, torch.float32).attempt_ops()
    attempts = int((cn[0] + cn[1]).sum())
    acc = int(cs[0].sum())
    item = 4
    nq, d, n_p = Q + 1, 2, 4
    W = st.shape[1]
    inp = (nq * d + n_p + 1) * B_MAIN * item
    grid_out = (us.numel() + sd.numel()) * item
    lane_out = B_MAIN * item + case.ea.N_COUNTS * B_MAIN * 4
    bounds = {
        n_filter: bound(inp + grid_out + lane_out, ops_att, 1, attempts)
        + (ops_att,),
        n_stream: bound(inp + acc * W * item + lane_out, ops_att, 1,
                        int((cs[0] + cs[1]).sum())) + (ops_att,),
        n_smoother: bound(
            acc * W * item + case.ea.N_COUNTS * B_MAIN * 4 + d * B_MAIN * item
            + grid_out, ops_step, 1, acc - B_MAIN) + (ops_step,),
    }
    say(f"   operations: {ops_att} per attempt and member ({attempts} "
        f"attempts in the filter's run), {ops_step} per smoothing step "
        f"({acc} accepted steps); stream written "
        f"{acc * W * item / 1e6:.1f} MB")
    for name, (b_ms, b_by, _) in bounds.items():
        say(f"   {name}: bound {b_ms:.4f} ms by {b_by}")
    del st, case
    torch.cuda.empty_cache()
    return ms, plain_ms, err, bounds


class EK1DFixed:
    """The fixed-grid DiagonalEK1 filter's arguments for one ensemble (the
    inputs of `Pair`, its constants rounded to the dtype as the front door
    makes them, the Jacobian diagonal as the front door takes it) and both
    versions of its kernel."""

    def __init__(self, B, T, dtype, tspan):
        from odefilters_torch.ops import ek1d

        self.ek1d = ek1d
        pair = Pair(B, T, dtype, tspan)
        self.prob, self.m0_p, self.ps = pair.prob, pair.m0_p, pair.ps
        dt = pair.fwd_kw["dt"]
        At, Qt, p = ek1d.filter_constants(Q, dt, dtype)
        self.kw = dict(At=At, Qt=Qt, pinv0=float(1.0 / p[0]),
                       pinv1=float(1.0 / p[1]), t0=tspan[0], dt=dt, n_steps=T)
        self.jd = ek1d.jac_diag_of(self.prob)

    def kernel(self, static=None):
        return self.ek1d.ek1d_filter(self.prob.f, self.jd, self.prob.field,
                                     self.m0_p, self.ps, static_diff=static,
                                     **self.kw)

    def plain(self, static=None):
        return self.ek1d.ek1d_filter_plain(self.prob.f, self.jd, self.m0_p,
                                           self.ps, static_diff=static,
                                           **self.kw)


def ek1d_fixed_vs_plain(label, case, rtol, atol, modes=(None,) + STATIC):
    """Phases 22 and 24: the fixed-grid DiagonalEK1 kernel against its plain
    version in each diffusion ``modes``: us, stds, lls and sigma^2 at
    ``rtol`` / ``atol`` (bit-for-bit equality reported). Returns the
    largest |kernel - plain| of the dynamic diffusion's outputs and the
    plain version's milliseconds (dynamic)."""
    err, plain_ms = 0.0, None
    for static in modes:
        ref, p_ms = once(lambda: case.plain(static))
        got = case.kernel(static)
        torch.cuda.synchronize()
        name = f"{label} ek1d_filter_kernel ({static or 'dynamic'})"
        whats = ("us", "stds", "lls", "sigma^2")
        for what, g, r in zip(whats, got, ref):
            e = close(f"{name}, {what}", g, r, rtol, atol)
            bitwise(f"{name}, {what}", g, r)
            if static is None:
                err = max(err, e)
        if static is None:
            plain_ms = p_ms
    return err, plain_ms


def ek1d_fixed_path(odt, card):
    """Phase 23, fixed grid: ``solve_ensemble(DiagonalEK1(smooth=False),
    adaptive=False)`` at 8192 x 500 in each diffusion mode, float32 and
    float64, each run with the count set to 0 before it and read after it:
    one launch, shapes, finite outputs, lls and sigma^2; float32 against
    float64 reported with counts (means on every entry, stds; the plain
    float32 covariance cancels); the float64 means against DOP853; and the
    float32 dynamic front door's time. Returns the float32 dynamic run's
    launches."""
    launches = {}
    sols = {}
    for mode in ("dynamic",) + STATIC:
        alg = odt.DiagonalEK1(order=Q, smooth=False, diffusionmodel=mode)
        for dtype in (torch.float32, torch.float64):
            prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
            reset_counts()
            sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN,
                                     adaptive=False)
            torch.cuda.synchronize()
            counts = read_counts("ek1d_filter")
            if dtype == torch.float32 and mode == "dynamic":
                launches.update(counts)
            label = str(dtype).replace("torch.", "")
            head = f"{label} solve_ensemble(DiagonalEK1({mode}), fixed grid)"
            check(counts["ek1d_filter"] == 1,
                  f"{head}: launches in the run {counts}, one")
            shape = (T_MAIN + 1, 2, B_MAIN)
            check(tuple(sol.us.shape) == shape == tuple(sol.stds.shape)
                  and bool(torch.isfinite(sol.us).all())
                  and bool(torch.isfinite(sol.stds).all()),
                  f"{head}: us, stds {tuple(sol.us.shape)}, finite")
            if mode == "dynamic":
                check(sol.diffusions is None
                      and bool(torch.isfinite(sol.lls).all()),
                      f"{head}: finite lls, no diffusions")
            else:
                check(bool(torch.isnan(sol.lls).all())
                      and bool((sol.diffusions > 0).all()),
                      f"{head}: NaN lls, positive diffusions "
                      f"{tuple(sol.diffusions.shape)}")
            sols[(mode, dtype)] = sol
        a, b = sols[(mode, torch.float32)], sols[(mode, torch.float64)]
        dus = (a.us.double() - b.us).abs()
        dsd = (a.stds.double() - b.stds).abs()
        member = int(dus.amax(dim=(0, 1)).argmax())
        lane = dus.amax(dim=(0, 1))
        outside = dsd > 1e-3 * b.stds.abs() + 1e-6
        # reported, not held: the fixed grid carries the plain covariance,
        # as the JAX kernel does, and in float32 its update Cp - k k^T s
        # cancels (on the CPU plain path at this shape, 454 members' means
        # miss float64 by more than 1e-4 under the dynamic diffusion,
        # scripts/torch_residual_census.py --only ek1d)
        zero_std = int((a.stds[1:] == 0).sum())
        say(f"   {mode} float32 vs float64 (reported): max |dus| "
            f"{float(dus.max()):.3e} (worst member {member}); "
            f"{int((lane > 1e-4).sum())} members above 1e-4; max |dstd| "
            f"{float(dsd.max()):.3e}, {int(outside.sum())} entries outside "
            f"1e-3 |std| + 1e-6 ({int(outside.any(dim=(0, 1)).sum())} "
            f"members; worst member's {int(outside[..., member].sum())}); "
            f"{zero_std} float32 stds after t0 are 0 (a covariance entry "
            f"C[0][0] <= 0, clamped)")
        if mode != "dynamic":
            rel = (a.diffusions.double() - b.diffusions).abs() / b.diffusions
            say(f"   {mode} sigma^2 float32 vs float64: largest relative "
                f"difference {float(rel.max()):.3e} (reported)")
    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    prob, u0s, ps = inputs(B_MAIN, torch.float64, TSPAN_MAIN)
    u0_np, p_np = u0s.cpu().numpy(), ps.cpu().numpy()
    us64 = sols[("dynamic", torch.float64)].us.cpu().numpy()
    members = sorted({0, 17, member, B_MAIN - 1})
    ref_err = max(
        float(np.abs(us64[:, :, k] - reference_solution(u0_np[k], p_np[k], ts)).max())
        for k in members)
    # 1.8e-6 at most over 256 members on the CPU plain path
    check(ref_err <= 1e-5, f"f64 DiagonalEK1 filter means vs DOP853 (members "
          f"{members}): max |dus| {ref_err:.3e} <= 1e-5")
    del sols
    prob, u0s, ps = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    alg = odt.DiagonalEK1(order=Q, smooth=False)
    d_ms = time_ms(lambda: odt.solve_ensemble(prob, alg, u0s, ps,
                                              n_save=T_MAIN, adaptive=False),
                   warmup=2, iters=10)
    say(f"   float32 solve_ensemble(DiagonalEK1(smooth=False), fixed grid, "
        f"dynamic): {d_ms:.3f} ms = {B_MAIN / d_ms * 1e3:.0f} solves/s "
        f"(median of 10 after 2 warm-ups; card: {card})")
    return launches


def ek1d_fixed_timing(card):
    """Phase 24, fixed grid: the kernel against its plain version at
    8192 x 500 in float32 (dynamic; the plain version once), its time and
    its bound. Returns (ms, plain ms, max |kernel - plain|, (bound_ms,
    bound_by, ops per step and member))."""
    case = EK1DFixed(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    err, plain_ms = ek1d_fixed_vs_plain(f"f32 at {B_MAIN} x {T_MAIN}", case,
                                        1e-4, 1e-6, modes=(None,))
    ms = time_ms(case.kernel, warmup=3, iters=20)
    one = EK1DFixed(1, 2, torch.float32,
                    (0.0, 2 * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN))

    def make(T1):
        kw = dict(one.kw, n_steps=T1)
        return lambda: one.ek1d.ek1d_filter_plain(one.prob.f, one.jd,
                                                  one.m0_p, one.ps, **kw)

    ops = count_ops(make)
    nq, d, n_p = Q + 1, 2, 4
    # each input read once (initial means, parameters), each output written
    # once (us and stds (T+1, d, B), lls)
    nbytes = ((nq * d + n_p) * B_MAIN + 2 * (T_MAIN + 1) * d * B_MAIN
              + B_MAIN) * 4
    b = bound(nbytes, ops, B_MAIN, T_MAIN)
    say(f"   ek1d_filter kernel {ms:.4f} ms, plain (once) {plain_ms:.1f} ms; "
        f"{ops} operations per step and member; {nbytes / 1e6:.1f} MB; bound "
        f"{b[0]:.4f} ms by {b[1]} (card: {card})")
    return ms, plain_ms, err, b + (ops,)


# The data likelihood (phases 28-30): the JAX package's data-likelihood row
# (benchmarks/run_all.py, tpu_datalik_sweep_pallas and its gradient):
# Lotka-Volterra over (0, 3) at u0 = (1, 1), parameters scaled per candidate
# by U(0.8, 1.2), EK0(order=3), 120 uniform steps, 9 observations (on the
# grid at DL_OBS_STEPS, or off it at DL_TS_OFF) of DOP853 truth with noise
# std 0.05.
DL_TSPAN, DL_T_MAIN, DL_T_CHECK = (0.0, 3.0), 120, 40
DL_OBS_STEPS = np.array([12, 40, 52, 64, 80, 96, 104, 112, 116])
DL_TS_OFF = np.linspace(0.31, 2.77, 9)
DL_NOISE, DL_SPREAD = 0.05, 0.2
# float32 against float64 on the worst member: |dll32 - dll64| within
# DL_NATS + DL_REL |dll64| nats. A member's dll sums the misfits of its 9
# observations, up to ~6e4 nats at the row's parameter spread, and float32
# keeps it to ~1e-4 of its size; DL_NATS covers the members whose dll is
# near 0, where a relative limit alone measures nothing.
DL_NATS, DL_REL = 0.01, 1e-3
# The check phase's parameter spread at T = 40 (dt = 0.075). At this step
# some members' filters diverge to non-finite values, in the plain version
# and the kernel alike: phase 28 holds the two on the same non-finite
# members and compares the rest, and reports the count at the row's spread.
DL_SPREAD_CHECK = 0.05
DL_NAMES = ("ek0_datalik", "ek0_datalik_grad_fwd", "ek0_datalik_grad_bwd")


def dl_times(T, grid):
    """The observation times: on the grid of T steps at the row's steps
    (scaled to T), or the off-grid times."""
    if grid == "off":
        return DL_TS_OFF
    dt = (DL_TSPAN[1] - DL_TSPAN[0]) / T
    return np.round(DL_OBS_STEPS * T / DL_T_MAIN) * dt


def lv_truth(ts):
    """Lotka-Volterra at the default u0 and p by DOP853, rtol = atol = 1e-12."""
    from scipy.integrate import solve_ivp

    def f(t, y):
        x, yy = y
        return [1.5 * x - x * yy, -3.0 * yy + x * yy]

    return solve_ivp(f, DL_TSPAN, [1.0, 1.0], method="DOP853", t_eval=ts,
                     rtol=1e-12, atol=1e-12).y.T


def dl_inputs(B, dtype, ts, spread):
    """The LV problem, u0s (B, 2) all (1, 1), ps scaled by U(1 -/+ spread)
    and ys: truth + DL_NOISE normals, from default_rng(7)."""
    from odefilters_torch import models

    prob = models.lotka_volterra(tspan=DL_TSPAN, device=DEVICE, dtype=dtype)
    rng = np.random.default_rng(7)
    ys = lv_truth(ts) + DL_NOISE * rng.standard_normal((len(ts), 2))
    ps = prob.p.cpu().numpy()[None] * rng.uniform(1 - spread, 1 + spread,
                                                  (B, 4))
    new = dict(dtype=dtype, device=DEVICE)
    return (prob, torch.ones((B, 2), **new), torch.tensor(ps, **new),
            torch.tensor(ys, **new))


class DataLik:
    """The data likelihood's kernel arguments for one ensemble (as the front
    door makes them), seeded cotangents, and both versions of its three
    kernels."""

    NAMES = DL_NAMES
    TIMED_STOP = False  # the adjoint's plain time: with calib_grad=True

    def __init__(self, B, T, dtype, grid, spread):
        from odefilters_torch.ops import ek0_datalik as ed

        self.ed = ed
        self.ts = dl_times(T, grid)
        self.prob, u0s, ps, ys = dl_inputs(B, dtype, self.ts, spread)
        self.m0_p, self.ps, self.ys, self.table, self.consts = ed.kernel_inputs(
            self.prob.f, u0s, ps, DL_TSPAN, T, self.ts, ys, DL_NOISE)
        rng = np.random.default_rng(1)
        self.cts = [torch.tensor(rng.standard_normal(B), dtype=dtype,
                                 device=DEVICE) for _ in range(2)]

    def args(self):
        return self.prob.f, self.prob.field, self.m0_p, self.ps, self.ys

    def restrict(self, keep):
        """Keep only the members ``keep`` (a boolean mask)."""
        self.m0_p = self.m0_p[..., keep].contiguous()
        self.ps = self.ps[:, keep].contiguous()
        self.cts = [c[keep].contiguous() for c in self.cts]

    def primal(self):
        return self.ed.ek0_datalik(*self.args(), self.table, **self.consts)

    def primal_plain(self):
        return self.ed.ek0_datalik_plain(self.prob.f, *self.args()[2:],
                                         self.table, **self.consts)

    def grad_fwd(self):
        return self.ed.ek0_datalik_grad_fwd(*self.args(), self.table,
                                            **self.consts)

    def grad_fwd_plain(self):
        return self.ed.ek0_datalik_fwd_stream_plain(
            self.prob.f, *self.args()[2:], self.table, **self.consts)

    def grad_bwd(self, st, stop_calib):
        return self.ed.ek0_datalik_grad_bwd(
            self.prob.f, self.prob.field, st, self.ps, self.ys, *self.cts,
            self.table, nq=Q + 1, stop_calib=stop_calib, **self.consts)

    def grad_bwd_plain(self, st, stop_calib):
        dm0, dps, part = self.ed.ek0_datalik_grad_bwd_plain(
            self.prob.f, st, self.ps, self.ys, *self.cts, self.table,
            nq=Q + 1, stop_calib=stop_calib, **self.consts)
        return dm0, dps, torch.sum(part, dim=-1)


def dl_hold_grads(name, got, ref, hold):
    """The adjoint's (dm0, dps, dys) against the plain adjoint's: held in
    float64 at the gradient tolerances of phase 7 (dm0 and dps against
    each row's scale over the members, dys entry by entry), reported in
    float32; bit-for-bit equality reported. Returns the largest |diff|."""
    for what, g, r in zip(("dm0", "dps", "dys"), got, ref):
        bitwise(f"{name}, {what}", g, r)
    if not hold:
        for what, g, r in zip(("dm0", "dps", "dys"), got, ref):
            report_grad(f"{name}, {what}", g, r)
        return max(float((g.double() - r.double()).abs().max())
                   for g, r in zip(got, ref))
    return max(close_rows(f"{name}, dm0", got[0], ref[0], 1e-8, 1e-10),
               close_rows(f"{name}, dps", got[1], ref[1], 1e-8, 1e-10),
               close(f"{name}, dys", got[2], ref[2], 1e-8, 1e-10))


def bitwise_nan(name, got, ref, strict=False):
    """Report whether ``got`` equals ``ref`` bit for bit, a NaN in both
    counting as equal (the data likelihood's members that diverge); with
    ``strict``, check it."""
    n = int(((got != ref) & ~(torch.isnan(got) & torch.isnan(ref))).sum())
    text = f"{name}: {'bit for bit' if n == 0 else f'{n} entries differ'}"
    if strict:
        check(n == 0, text)
    else:
        say(f"   {text}")


def close_where_finite(name, got, ref, rtol, atol):
    """`close` on the entries where ``ref`` is finite, after checking that
    ``got`` is finite exactly there; returns the largest |diff|."""
    fin = torch.isfinite(ref)
    check(torch.equal(torch.isfinite(got), fin),
          f"{name}: non-finite on the same {int((~fin).sum())} entries")
    return close(name, got[fin], ref[fin], rtol, atol)


def datalik_vs_plain(label, case, rtol, atol, hold_grads, strict=False,
                     stops=(False, True), dll_only_too=True):
    """Phases 28, 30, 31 and 33 for one ensemble: the primal kernel and
    the gradient's forward against their plain versions (dll, ll held
    where the plain version is finite, the two non-finite on the same
    members; bit-for-bit equality, NaN members alike, reported, or with
    ``strict`` checked; the stream held bit for bit on the members that
    stay finite), then on those members the adjoint on the plain forward's
    stream with calib_grad both ways, or with ``stop_calib`` in ``stops``
    only (float32 per-dimension cases: `pd_f32_adjoint`, with the cotangent
    of dll alone too unless not ``dll_only_too``). ``case.NAMES``: its three
    kernels. Returns each
    kernel's largest |kernel - plain| (the adjoint's also for each
    calib_grad, under ``"<name> calib_grad=<bool>"``) and the plain
    versions' milliseconds."""
    primal, fwd, bwd = case.NAMES
    err, p_ms = {}, {}
    (dll_p, ll_p), p_ms[primal] = once(case.primal_plain)
    dll_k, ll_k = case.primal()
    torch.cuda.synchronize()
    name = f"{label} {primal}_kernel"
    bitwise_nan(f"{name}, dll", dll_k, dll_p, strict)
    bitwise_nan(f"{name}, ll", ll_k, ll_p, strict)
    err[primal] = max(
        close_where_finite(f"{name}, dll", dll_k, dll_p, rtol, atol),
        close_where_finite(f"{name}, ll", ll_k, ll_p, rtol, atol))
    (dll_p, ll_p, st_p), p_ms[fwd] = once(case.grad_fwd_plain)
    dll_k, ll_k, st_k = case.grad_fwd()
    torch.cuda.synchronize()
    name = f"{label} {fwd}_kernel"
    for what, g, r in (("dll", dll_k, dll_p), ("ll", ll_k, ll_p)):
        bitwise_nan(f"{name}, {what}", g, r, strict)
    err[fwd] = max(
        close_where_finite(f"{name}, dll", dll_k, dll_p, rtol, atol),
        close_where_finite(f"{name}, ll", ll_k, ll_p, rtol, atol))
    keep = (torch.isfinite(st_p).all(dim=(0, 1)) & torch.isfinite(dll_p)
            & torch.isfinite(ll_p))
    # the stream, the state after each step's data update, is what the
    # adjoint reads: held bit for bit on the members that stay finite
    bitwise(f"{name}, stream on the {int(keep.sum())} members that stay "
            "finite", st_k[..., keep], st_p[..., keep], strict=True)
    if not keep.all():
        case.restrict(keep)
        st_p = st_p[..., keep].contiguous()
    err[bwd] = 0.0
    for stop in stops:
        ref, ms = once(lambda: case.grad_bwd_plain(st_p, stop))
        if stop == case.TIMED_STOP:
            p_ms[bwd] = ms
        got = case.grad_bwd(st_p, stop)
        torch.cuda.synchronize()
        name = (f"{label} {bwd}_kernel (calib_grad={not stop}, on the plain "
                "stream)")
        if hold_grads or not hasattr(case, "grad_bwd_f64"):
            e = dl_hold_grads(name, got, ref, hold_grads)
        else:
            e = pd_f32_adjoint(name, case, st_p, stop, got, ref,
                               dll_only_too)
        err[f"{bwd} calib_grad={not stop}"] = e
        err[bwd] = max(err[bwd], e)
    return err, p_ms


def datalik_check(card):
    """Phase 28: the three kernels against their plain versions at B_CHECK
    members, T = DL_T_CHECK, on the grid and off it, float64 and float32
    (`datalik_vs_plain`); and the float32 members that diverge at the row's
    parameter spread at this step, counted in the plain version and the
    kernel."""
    for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12),
                              (torch.float32, 1e-4, 1e-6)):
        label = str(dtype).replace("torch.", "")
        for grid in ("on", "off"):
            case = DataLik(B_CHECK, DL_T_CHECK, dtype, grid, DL_SPREAD_CHECK)
            say(f"   {label}, {grid} the grid: {case.table.n_steps} steps, "
                f"{len(case.table.odd)} odd step lengths")
            datalik_vs_plain(f"{label} {grid}-grid", case, rtol, atol,
                             hold_grads=dtype == torch.float64)
    case = DataLik(B_CHECK, DL_T_CHECK, torch.float32, "on", DL_SPREAD)
    (dll_p, ll_p), (dll_k, ll_k) = case.primal_plain(), case.primal()
    torch.cuda.synchronize()
    bad_p = ~(torch.isfinite(dll_p) & torch.isfinite(ll_p))
    bad_k = ~(torch.isfinite(dll_k) & torch.isfinite(ll_k))
    say(f"   float32 at spread {DL_SPREAD}, T={DL_T_CHECK}: "
        f"{int(bad_p.sum())} of {B_CHECK} members diverge in the plain "
        f"version, {int(bad_k.sum())} in the kernel, the same members: "
        f"{bool(torch.equal(bad_p, bad_k))} (reported)")
    bitwise("float32 at that spread, ek0_datalik_kernel dll",
            dll_k[~bad_p], dll_p[~bad_p])


def dl_door(odt, prob, u0s, ps, ys, ts, calib_grad=True):
    return odt.ensemble_data_loglik(prob.f, u0s, ps, DL_TSPAN, DL_T_MAIN, ts,
                                    ys, DL_NOISE, field=prob.field,
                                    calib_grad=calib_grad)


def dl_grad(odt, prob, u0s, ps, ys, ts, calib_grad=True):
    """Gradient of sum(dll) in (u0s, ps, ys) through the front door."""
    args = [x.clone().requires_grad_() for x in (u0s, ps, ys)]
    dll, _ = dl_door(odt, prob, *args, ts, calib_grad)
    return torch.autograd.grad(dll.sum(), args)


def datalik_path(odt, card):
    """Phase 29: the front door at the row's width, on the grid and off it,
    float32 and float64, each run with the counts set to 0 before it and
    read after it: launches, shapes and finite outputs; float32 against
    float64 on the worst member; the float64 primal kernel against its
    plain version; the float64 gradient against central differences; the
    float32 gradients against float64's (reported). On the grid also the
    float64 adjoint against the plain adjoint at this shape. Returns the
    float32 on-grid runs' launches and the adjoint's largest |diff|."""
    launches, err_adjoint = {}, 0.0
    for grid in ("on", "off"):
        ts = dl_times(DL_T_MAIN, grid)
        out = {}
        for dtype in (torch.float32, torch.float64):
            label = f"{str(dtype).replace('torch.', '')} {grid}-grid"
            prob, u0s, ps, ys = dl_inputs(B_MAIN, dtype, ts, DL_SPREAD)
            reset_counts()
            with torch.no_grad():
                dll, ll = dl_door(odt, prob, u0s, ps, ys, ts)
            torch.cuda.synchronize()
            c_primal = read_counts(*DL_NAMES)
            reset_counts()
            g = dl_grad(odt, prob, u0s, ps, ys, ts)
            torch.cuda.synchronize()
            c_grad = read_counts(*DL_NAMES)
            check(tuple(c_primal.values()) == (1, 0, 0)
                  and tuple(c_grad.values()) == (0, 1, 1),
                  f"{label}: launches in the primal run {c_primal}, in the "
                  f"gradient run {c_grad} (1/0/0 and 0/1/1)")
            if dtype == torch.float32 and grid == "on":
                launches = {"ek0_datalik": c_primal["ek0_datalik"],
                            "ek0_datalik_grad_fwd":
                                c_grad["ek0_datalik_grad_fwd"],
                            "ek0_datalik_grad_bwd":
                                c_grad["ek0_datalik_grad_bwd"]}
            gs = dl_grad(odt, prob, u0s, ps, ys, ts, calib_grad=False)
            shapes = (tuple(dll.shape), tuple(ll.shape)) + tuple(
                tuple(x.shape) for x in g)
            check(shapes == ((B_MAIN,), (B_MAIN,), (B_MAIN, 2), (B_MAIN, 4),
                             (9, 2)),
                  f"{label}: shapes dll, ll, d/du0s, d/dps, d/dys {shapes}")
            finite = all(bool(torch.isfinite(x).all())
                         for x in (dll, ll) + g + gs)
            check(finite, f"{label}: values and gradients finite")
            out[dtype] = (prob, u0s, ps, ys, dll, ll, g, gs)
        prob64, u64, p64, y64, dll64, ll64, g64, gs64 = out[torch.float64]
        _, _, _, _, dll32, ll32, g32, gs32 = out[torch.float32]
        # a log-likelihood is held in nats: 0.01 plus 1e-4 of its size
        err = (dll32.double() - dll64).abs()
        ratio = err / (DL_NATS + DL_REL * dll64.abs())
        member = int(ratio.argmax())
        check(float(ratio[member]) <= 1.0,
              f"{grid}-grid float32 vs float64 dll, worst member {member}: "
              f"|diff| {float(err[member]):.3e} nats <= {DL_NATS} + {DL_REL} "
              f"|dll64| (dll64 {float(dll64[member]):.6f}), "
              f"{float(ratio[member]):.3f} of the limit; largest |diff| "
              f"{float(err.max()):.3e}, largest relative "
              f"{float((err / dll64.abs()).max()):.3e}")
        rel_ll = (ll32.double() - ll64).abs() / ll64.abs()
        say(f"   {grid}-grid float32 vs float64 ll: largest relative "
            f"{float(rel_ll.max()):.3e} (member {int(rel_ll.argmax())}; "
            "reported)")
        for what, a, b in (("calib_grad=True", g32, g64),
                           ("calib_grad=False", gs32, gs64)):
            text = ", ".join(
                f"d/d{n} {float((x.double() - y).norm() / y.norm()):.3e}"
                for n, x, y in zip(("u0s", "ps", "ys"), a, b))
            say(f"   {grid}-grid float32 vs float64 gradient of sum(dll), "
                f"{what}: relative norm difference {text} (reported)")
        case = DataLik(B_MAIN, DL_T_MAIN, torch.float64, grid, DL_SPREAD)
        (dll_p, ll_p), (dll_k, ll_k) = case.primal_plain(), case.primal()
        torch.cuda.synchronize()
        name = f"f64 {grid}-grid ek0_datalik_kernel vs plain at {B_MAIN} x {DL_T_MAIN}"
        bitwise(f"{name}, dll", dll_k, dll_p)
        close(f"{name}, dll", dll_k, dll_p, 1e-10, 1e-12)
        close(f"{name}, ll", ll_k, ll_p, 1e-10, 1e-12)
        check(torch.equal(dll_k, dll64) and torch.equal(ll_k, ll64),
              f"{grid}-grid f64: the front door's values are the kernel's")
        if grid == "on":
            st = case.grad_fwd_plain()[2]
            got, ref = case.grad_bwd(st, False), case.grad_bwd_plain(st, False)
            torch.cuda.synchronize()
            err_adjoint = dl_hold_grads(
                f"f64 ek0_datalik_grad_bwd_kernel vs plain at {B_MAIN} x "
                f"{DL_T_MAIN}", got, ref, hold=True)
        del case
        # central differences of sum(dll) in float64 along a seeded direction
        rng = np.random.default_rng(7)
        v = [torch.tensor(rng.standard_normal(tuple(x.shape)), device=DEVICE)
             for x in (u64, p64, y64)]
        v[1] = v[1] * p64
        ad = float(sum((a * b).sum() for a, b in zip(g64, v)))
        for eps in (1e-4, 1e-5, 1e-6):
            with torch.no_grad():
                plus, minus = (float(dl_door(odt, prob64, u64 + s * v[0],
                                             p64 + s * v[1], y64 + s * v[2],
                                             ts)[0].sum())
                               for s in (eps, -eps))
            fd = (plus - minus) / (2 * eps)
            r = abs(fd - ad) / abs(ad)
            text = (f"{grid}-grid f64 gradient of sum(dll) vs central "
                    f"difference, step {eps:g}: autograd {ad:.9e}, difference "
                    f"{fd:.9e}, relative {r:.3e}")
            if eps == 1e-6:
                check(r <= 1e-6, f"{text} <= 1e-6")
            else:
                say(f"   {text} (reported)")
        del out
        torch.cuda.empty_cache()
    return launches, err_adjoint


def datalik_timing(odt, card):
    """Phase 30: float32 at the row's width on the grid: each kernel
    against its plain version (the plain versions run once), the kernels'
    and the front doors' times (median of 20 after 3 warm-ups, CUDA
    events) and the primal door's host work (the step table's build, the
    Taylor init) timed alone, the kernels' bounds from this run's stream and the plain versions'
    operations on one member of this schedule. Returns (ms, plain ms, max
    |kernel - plain|, {name: (bound_ms, bound_by, operations per
    member)})."""
    from odefilters_torch.ops import ek0_datalik as ed

    case = DataLik(B_MAIN, DL_T_MAIN, torch.float32, "on", DL_SPREAD)
    err, p_ms = datalik_vs_plain(f"f32 at {B_MAIN} x {DL_T_MAIN}", case, 1e-4,
                                 1e-6, hold_grads=False)
    st = case.grad_fwd()[2]
    ms = {"ek0_datalik": time_ms(case.primal, warmup=3, iters=20),
          "ek0_datalik_grad_fwd": time_ms(case.grad_fwd, warmup=3, iters=20),
          "ek0_datalik_grad_bwd": time_ms(lambda: case.grad_bwd(st, False),
                                          warmup=3, iters=20)}
    ms_stop = time_ms(lambda: case.grad_bwd(st, True), warmup=3, iters=20)
    for name in DL_NAMES:
        say(f"   {name} kernel {ms[name]:.4f} ms, plain {p_ms[name]:.1f} ms "
            f"(card: {card})")
    say(f"   ek0_datalik_grad_bwd kernel with calib_grad=False "
        f"{ms_stop:.4f} ms")
    for grid in ("on", "off"):
        ts = dl_times(DL_T_MAIN, grid)
        prob, u0s, ps, ys = dl_inputs(B_MAIN, torch.float32, ts, DL_SPREAD)

        def primal():
            with torch.no_grad():
                dl_door(odt, prob, u0s, ps, ys, ts)

        def table():
            ed.data_table(DL_TSPAN, DL_T_MAIN, ts, Q, torch.float32, DEVICE)

        def init():
            with torch.no_grad():
                ed.initial_means(prob.f, u0s, ps, DL_TSPAN, DL_T_MAIN, Q)

        t_ms = time_ms(table, warmup=3, iters=20)
        i_ms = time_ms(init, warmup=3, iters=20)
        d_ms = time_ms(primal, warmup=3, iters=20)
        g_ms = time_ms(lambda: dl_grad(odt, prob, u0s, ps, ys, ts),
                       warmup=3, iters=20)
        gs_ms = time_ms(lambda: dl_grad(odt, prob, u0s, ps, ys, ts, False),
                        warmup=3, iters=20)
        say(f"   {grid}-grid float32 ensemble_data_loglik: {d_ms:.3f} ms = "
            f"{B_MAIN / d_ms * 1e3:.0f} candidates/s; forward + backward of "
            f"sum(dll): {g_ms:.3f} ms = {B_MAIN / g_ms * 1e3:.0f} gradient "
            f"candidates/s; with calib_grad=False {gs_ms:.3f} ms; of the "
            f"primal door: the step table's host build {t_ms:.3f} ms, the "
            f"Taylor init {i_ms:.3f} ms, the kernel {ms['ek0_datalik']:.4f} "
            f"ms on the grid")
    # bounds: the stream and the inputs and outputs each moved once; the
    # plain versions' operations on one member of this schedule
    one = DataLik(1, DL_T_MAIN, torch.float32, "on", DL_SPREAD)
    st1 = one.grad_fwd_plain()[2]
    ops = {"ek0_datalik": ops_of(one.primal_plain),
           "ek0_datalik_grad_fwd": ops_of(one.grad_fwd_plain),
           "ek0_datalik_grad_bwd": ops_of(lambda: one.grad_bwd_plain(st1,
                                                                     False))}
    nq, d, n_p, item = Q + 1, 2, 4, 4
    T, V, n_obs = case.table.n_steps, st.shape[1], case.ys.shape[0]
    shared = (T * item + 2 * T * 4 + case.table.odd_flat.numel() * 8
              + n_obs * d * item)
    init, stream = (nq * d + n_p) * B_MAIN * item, T * V * B_MAIN * item
    nbytes = {"ek0_datalik": init + shared + 2 * B_MAIN * item,
              "ek0_datalik_grad_fwd": init + shared + 2 * B_MAIN * item + stream,
              "ek0_datalik_grad_bwd": stream + n_p * B_MAIN * item + shared
              + 2 * B_MAIN * item + (nq * d + n_p + n_obs * d) * B_MAIN * item}
    bounds = {}
    for name in DL_NAMES:
        bounds[name] = bound(nbytes[name], ops[name], B_MAIN, 1) + (ops[name],)
        say(f"   {name}: {ops[name]} operations per member over {T} steps; "
            f"{nbytes[name] / 1e6:.1f} MB; bound {bounds[name][0]:.4f} ms by "
            f"{bounds[name][1]}")
    del case, st
    torch.cuda.empty_cache()
    return ms, p_ms, err, bounds


def datalik_phases(odt, card, built):
    """Phases 28-30. Returns (launches on the main path's runs, ms, plain
    ms, max |kernel - plain|, bounds) of the three data-likelihood
    kernels."""
    say(f"== 28. the data-likelihood kernels vs plain, B={B_CHECK}, "
        f"LV over {DL_TSPAN}, T={DL_T_CHECK}, on and off the grid, float64 "
        "and float32, calib_grad both ways")
    datalik_check(card)
    say(f"== 29. the data likelihood's path: ensemble_data_loglik, B={B_MAIN}, "
        f"LV over {DL_TSPAN}, T={DL_T_MAIN}, 9 observations on and off the "
        "grid")
    launches, err_adjoint = datalik_path(odt, card)
    say(f"== 30. the data-likelihood kernels vs plain and timing, float32, "
        f"B={B_MAIN}, T={DL_T_MAIN}")
    ms, p_ms, err, bounds = datalik_timing(odt, card)
    err["ek0_datalik_grad_bwd"] = err_adjoint
    print_registers(built["log"], DL_NAMES)
    return launches, ms, p_ms, err, bounds


# The per-dimension data likelihood (phases 31-33): the JAX package's rows
# tpu_datalik_partial_obs_pallas (prey-only observations, C = [[1, 0]]), its
# gradient tpu_datalik_partial_obs_grad_pallas (calib_grad=False) and
# tpu_datalik_ek1d_pallas (DiagonalEK1, full state) of
# benchmarks/run_all.py:789-820, 848-862, at the width of phases 28-30
# (8192 candidates, parameters scaled by U(0.8, 1.2), 120 steps, the 9
# on-grid observations, noise std 0.05), and per-member observations at
# that width.
PD_NAMES = ("ek0_datalik_pd", "ek0_datalik_pd_grad_fwd",
            "ek0_datalik_pd_grad_bwd")
# The check phase: 3 observations at steps 8, 20 and 32 of T = 40 (the JAX
# package's own tests), two observation models: C = [[2, 0]] (a scale of 1
# would hide a missing one) with scalar noise, and the full state with
# per-dimension noise.
PD_CHECK_STEPS = np.array([8, 20, 32])
PD_CHECK_MODELS = {"C=[[2,0]] r=0.1": (np.array([[2.0, 0.0]]), 0.1),
                   "full r=(0.1,0.3)": (None, np.array([0.1, 0.3]))}
# The check's cases (DiagonalEK1, model, per-member data): each step and
# each observation model with shared and with per-member data.
PD_CHECK_CASES = ((False, "C=[[2,0]] r=0.1", False),
                  (False, "full r=(0.1,0.3)", True),
                  (True, "C=[[2,0]] r=0.1", True),
                  (True, "full r=(0.1,0.3)", False))
# The path's rows: (obs_matrix, DiagonalEK1, per-member data, the row's
# gradient's calib_grad).
PD_ROWS = {"partial": (np.array([[1.0, 0.0]]), False, False, False),
           "ek1d": (None, True, False, True),
           "per_member": (None, False, True, True)}
# The DiagonalEK1 row's float32 dll against float64: every member within
# DL_NATS + DL_REL |dll64| but at most PD_EK1D_OVER, all finite. It carries
# the JAX kernel's plain covariance update, which float32 can drive
# indefinite on a badly fitting member: 1 member of 8192 over the limit in
# the port, on the card and on the CPU alike, and 15 of 8192 in the JAX
# kernel's own float32 run on the same inputs (interpret mode on the CPU:
# test_float32_diagonal_ek1_row_against_jax_float32 in
# tests/test_torch_ek0_datalik_pd.py). A wrong kernel puts most members
# over it.
PD_EK1D_OVER = 8
# The float32 adjoint (phases 31 and 33) against its plain version on the
# same stream, and each against the float64 run's adjoint on the same
# inputs, for two cotangents: seeded normals on (dll, ll), and on dll only
# (ll's cotangent 0: the gradient of the data log-likelihood that the
# front door's users take). Held: the kernel no farther from float64 than
# PD_F32_FACTOR times the plain version, plus PD_F32_ADJOINT, in relative
# norm, where the plain version has a correct digit (within 1 of float64
# in every output). Where it has none, the two float32 versions differ by
# as much as either differs from float64: reported. That happens at 8192 x
# 120 with calib_grad=True (the calibration's cotangent scales with the
# residual over hq, and float32 rounds the residual of a well-resolved
# step to noise) and on the DiagonalEK1 row with the cotangent of ll too
# (ll sums those residuals).
PD_F32_FACTOR, PD_F32_ADJOINT = 4.0, 1e-4
# The float64 adjoint at 8192 x 120 (phase 32): within 1e-8 of each row's
# scale, or PD_F64_FACTOR times the plain adjoint's own movement when its
# stream is perturbed by one ulp, whichever is larger. With calib_grad=True
# that movement exceeds 1e-8 (the prey-only row ~1.5e-8, the DiagonalEK1
# row ~9e-7: the conditioning that float32 shows, at float64's rounding),
# and the kernel rounds in another order.
PD_F64_FACTOR = 4.0


def row_scaled(got, ref, members):
    """(relative norm difference, largest |diff| over its row's scale) of
    an adjoint output; the rows run over the members (the last axis), or,
    without a member axis (``members`` false: shared observations), each
    entry is its own row."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    scale = ref.abs().amax(dim=-1, keepdim=True) if members else ref.abs()
    return (float((got - ref).norm() / ref.norm()),
            float((err / scale.clamp(min=1e-300)).max()))


def pd_f32_adjoint(name, case, st, stop_calib, got, ref, dll_only_too=True):
    """The float32 adjoint ``got`` against its plain version ``ref`` on the
    stream ``st``, then (``dll_only_too``) again with the cotangent of dll
    only: per output
    (dm0, dps, dys), the relative norm difference and the largest |diff|
    over its row's scale, and each version's relative norm distance from
    the float64 run's adjoint (`DataLikPD.grad_bwd_f64`), held finite and,
    where the plain version has a correct digit, within PD_F32_FACTOR
    times the plain version's plus PD_F32_ADJOINT. Returns the largest
    |kernel - plain| with the first cotangent."""
    err = None
    for dll_only in (False, True) if dll_only_too else (False,):
        if dll_only:
            got = case.grad_bwd(st, stop_calib, dll_only=True)
            ref = case.grad_bwd_plain(st, stop_calib, dll_only=True)
            torch.cuda.synchronize()
        wit = case.grad_bwd_f64(stop_calib, dll_only)
        which = "dll only" if dll_only else "dll and ll"
        rows = [(what, row_scaled(g, r, m), row_scaled(g, w, m)[0],
                 row_scaled(r, w, m)[0], bool(torch.isfinite(g).all()))
                for what, g, r, w, m in zip(("dm0", "dps", "dys"), got, ref,
                                            wit, case.members)]
        digit = max(dp for *_, dp, _ in rows) < 1.0
        for what, (rn, rs), dk, dp, finite in rows:
            text = (f"{name}, cotangent of {which}, {what}: kernel vs plain "
                    f"relative norm difference {rn:.3e}, largest |diff| / its "
                    f"row's scale {rs:.3e}; from the float64 run's adjoint: "
                    f"kernel {dk:.3e}, plain {dp:.3e}; finite={finite}")
            if digit:
                check(finite and dk <= PD_F32_FACTOR * dp + PD_F32_ADJOINT,
                      f"{text}; held: kernel <= {PD_F32_FACTOR:g} x plain + "
                      f"{PD_F32_ADJOINT:g}")
            else:
                check(finite, f"{text} (reported: the plain float32 adjoint "
                      "has no correct digit here)")
        if err is None:
            err = max(float((g.double() - r.double()).abs().max())
                      for g, r in zip(got, ref))
    return err


def pd_f64_adjoint(name, got, ref, moved, members):
    """The float64 adjoint ``got`` against its plain version ``ref``, per
    output: the largest |diff| over its row's scale held within 1e-8 or
    PD_F64_FACTOR times that of ``moved`` (the plain adjoint on the stream
    perturbed by one ulp), whichever is larger; all finite."""
    for what, g, r, mv, m in zip(("dm0", "dps", "dys"), got, ref, moved,
                                 members):
        rs, floor = row_scaled(g, r, m)[1], row_scaled(mv, r, m)[1]
        limit = max(1e-8, PD_F64_FACTOR * floor)
        finite = bool(torch.isfinite(g).all())
        check(finite and rs <= limit,
              f"{name}, {what}: largest |diff| / its row's scale {rs:.3e} <= "
              f"{limit:.3e} (1e-8, or {PD_F64_FACTOR:g} x {floor:.3e}: the "
              f"plain adjoint's own movement under a one-ulp perturbation of "
              f"its stream); max |diff| "
              f"{float((g.double() - r.double()).abs().max()):.3e}; "
              f"finite={finite}")


def pd_obs(ys, ts, C, B, per_member):
    """The observations of ``C @ u(t)`` (C None: the full state): shared,
    ``ys`` of `dl_inputs` through C; per member ``(B, n_obs, d_obs)``, the
    DOP853 truth through C plus DL_NOISE normals from default_rng(11)."""
    C = np.eye(2) if C is None else C
    if not per_member:
        return ys @ torch.tensor(C.T, dtype=ys.dtype, device=ys.device)
    truth = lv_truth(ts) @ C.T
    rng = np.random.default_rng(11)
    y = truth[None] + DL_NOISE * rng.standard_normal((B,) + truth.shape)
    return torch.tensor(y, dtype=ys.dtype, device=DEVICE)


class DataLikPD:
    """The per-dimension data likelihood's kernel arguments for one
    ensemble (as the front door makes them), seeded cotangents, and both
    versions of its three kernels. The plain versions take the problem's
    Jacobian diagonal (``jac``'s diagonal, in the CUDA field's order of
    operations); the kernels evaluate the field's own."""

    NAMES = PD_NAMES
    TIMED_STOP = True  # the JAX row's gradient: calib_grad=False

    def __init__(self, B, T, dtype, ts, spread, C, noise, diagonal,
                 per_member):
        from odefilters_torch.ops import ek0_datalik as ed
        from odefilters_torch.ops import ek0_datalik_pd as edp
        from odefilters_torch.ops import ek1d

        self.edp = edp
        self.spec = (B, T, ts, spread, C, noise, diagonal, per_member)
        self.keep, self.twin = None, None
        self.prob, u0s, ps, ys = dl_inputs(B, dtype, ts, spread)
        ys = pd_obs(ys, ts, C, B, per_member)
        self.m0_p, self.ps, self.ys, self.table, self.consts = \
            ed.pd_kernel_inputs(self.prob.f, u0s, ps, DL_TSPAN, T, ts, ys,
                                noise, Q, obs_matrix=C)
        self.jd = ek1d.jac_diag_of(self.prob) if diagonal else None
        self.members = (True, True, per_member)
        rng = np.random.default_rng(1)
        self.cts = [torch.tensor(rng.standard_normal(B), dtype=dtype,
                                 device=DEVICE) for _ in range(2)]

    def restrict(self, keep):
        """Keep only the members ``keep`` (a boolean mask)."""
        self.keep = keep
        self.m0_p = self.m0_p[..., keep].contiguous()
        self.ps = self.ps[:, keep].contiguous()
        self.cts = [c[keep].contiguous() for c in self.cts]
        if self.ys.ndim == 3:
            self.ys = self.ys[..., keep].contiguous()

    def primal(self):
        return self.edp.ek0_datalik_pd(
            self.prob.f, self.jd, self.prob.field, self.m0_p, self.ps,
            self.ys, self.table, **self.consts)

    def primal_plain(self):
        return self.edp.ek0_datalik_pd_plain(
            self.prob.f, self.jd, self.m0_p, self.ps, self.ys, self.table,
            **self.consts)

    def grad_fwd(self):
        return self.edp.ek0_datalik_pd_grad_fwd(
            self.prob.f, self.jd, self.prob.field, self.m0_p, self.ps,
            self.ys, self.table, **self.consts)

    def grad_fwd_plain(self):
        return self.edp.ek0_datalik_pd_fwd_stream_plain(
            self.prob.f, self.jd, self.m0_p, self.ps, self.ys, self.table,
            **self.consts)

    def _cts(self, dll_only):
        """The cotangents of (dll, ll); with ``dll_only``, ll's is 0."""
        ddll, dall = self.cts
        return ddll, torch.zeros_like(dall) if dll_only else dall

    def grad_bwd(self, st, stop_calib, dll_only=False):
        return self.edp.ek0_datalik_pd_grad_bwd(
            self.prob.f, self.jd, self.prob.field, st, self.ps, self.ys,
            *self._cts(dll_only), self.table, nq=Q + 1,
            stop_calib=stop_calib, **self.consts)

    def grad_bwd_plain(self, st, stop_calib, dll_only=False):
        dm0, dps, part = self.edp.ek0_datalik_pd_grad_bwd_plain(
            self.prob.f, self.jd, st, self.ps, self.ys, *self._cts(dll_only),
            self.table, nq=Q + 1, stop_calib=stop_calib, **self.consts)
        return dm0, dps, part if self.ys.ndim == 3 else torch.sum(part, -1)

    def grad_bwd_f64(self, stop_calib, dll_only=False):
        """The float64 run's plain adjoint on the members kept: the same
        ensemble in float64, its own plain stream, this case's cotangents
        upcast; what the float32 adjoint approximates."""
        if self.twin is None:
            twin = type(self)(*self.spec[:2], torch.float64, *self.spec[2:])
            if self.keep is not None:
                twin.restrict(self.keep)
            twin.cts = [c.double() for c in self.cts]
            self.twin = twin, twin.grad_fwd_plain()[2]
        twin, st = self.twin
        return twin.grad_bwd_plain(st, stop_calib, dll_only)


def pd_check():
    """Phase 31: the three per-dimension kernels against their plain
    versions at B_CHECK members, T = DL_T_CHECK, 3 observations, float64
    and float32, in each case of PD_CHECK_CASES (`datalik_vs_plain`,
    strict: the primal and the gradient's forward bit for bit, NaN members
    alike)."""
    ts = PD_CHECK_STEPS * (DL_TSPAN[1] - DL_TSPAN[0]) / DL_T_CHECK
    for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12),
                              (torch.float32, 1e-4, 1e-6)):
        for diagonal, model, per_member in PD_CHECK_CASES:
            C, noise = PD_CHECK_MODELS[model]
            label = (f"{str(dtype).replace('torch.', '')} "
                     f"{'DiagonalEK1' if diagonal else 'EK0'} {model} "
                     f"{'per-member' if per_member else 'shared'} ys")
            case = DataLikPD(B_CHECK, DL_T_CHECK, dtype, ts, DL_SPREAD_CHECK,
                             C, noise, diagonal, per_member)
            datalik_vs_plain(label, case, rtol, atol,
                             hold_grads=dtype == torch.float64, strict=True)


def pd_door(odt, prob, u0s, ps, ys, ts, row, calib_grad=True):
    C, diagonal, _, _ = PD_ROWS[row]
    return odt.ensemble_data_loglik(
        prob.f, u0s, ps, DL_TSPAN, DL_T_MAIN, ts, ys, DL_NOISE,
        field=prob.field, obs_matrix=C, diagonal_ek1=diagonal,
        calib_grad=calib_grad)


def pd_grad(odt, prob, u0s, ps, ys, ts, row, calib_grad):
    """Gradient of sum(dll) in (u0s, ps, ys) through the front door."""
    args = [x.clone().requires_grad_() for x in (u0s, ps, ys)]
    dll, _ = pd_door(odt, prob, *args, ts, row, calib_grad)
    return torch.autograd.grad(dll.sum(), args)


def pd_path(odt):
    """Phase 32: the front door at the rows of PD_ROWS, float32 and
    float64, each run with the counts set to 0 before it and read after it:
    launches 1/0/0 for the primal, 0/1/1 for the row's gradient of sum(dll)
    in (u0s, ps, ys); shapes and finite values and gradients; float32
    against float64 on the worst member (DL_NATS + DL_REL |dll|; the
    DiagonalEK1 row: all but at most PD_EK1D_OVER members) and the float32
    gradients' relative norm difference from float64 with calib_grad both
    ways, also without the members over that limit and without the 10
    members farthest apart; the float64 door's values equal to the primal
    kernel's; the float64 adjoint against the plain adjoint at this shape
    with calib_grad both ways (`pd_f64_adjoint`); the float64 gradient
    (calib_grad=True)
    against central differences of sum(dll) in ps. Returns the float32
    partial row's launches."""
    launches = {}
    ts = dl_times(DL_T_MAIN, "on")
    for row, (C, diagonal, per_member, row_calib) in PD_ROWS.items():
        out = {}
        for dtype in (torch.float32, torch.float64):
            label = f"{str(dtype).replace('torch.', '')} {row}"
            prob, u0s, ps, ys = dl_inputs(B_MAIN, dtype, ts, DL_SPREAD)
            ys = pd_obs(ys, ts, C, B_MAIN, per_member)
            reset_counts()
            with torch.no_grad():
                dll, ll = pd_door(odt, prob, u0s, ps, ys, ts, row)
            torch.cuda.synchronize()
            c_primal = read_counts(*PD_NAMES)
            reset_counts()
            g = pd_grad(odt, prob, u0s, ps, ys, ts, row, row_calib)
            torch.cuda.synchronize()
            c_grad = read_counts(*PD_NAMES)
            check(tuple(c_primal.values()) == (1, 0, 0)
                  and tuple(c_grad.values()) == (0, 1, 1),
                  f"{label}: launches in the primal run {c_primal}, in the "
                  f"gradient run (calib_grad={row_calib}) {c_grad} (1/0/0 "
                  "and 0/1/1)")
            if dtype == torch.float32 and row == "partial":
                launches = {"ek0_datalik_pd": c_primal["ek0_datalik_pd"],
                            "ek0_datalik_pd_grad_fwd":
                                c_grad["ek0_datalik_pd_grad_fwd"],
                            "ek0_datalik_pd_grad_bwd":
                                c_grad["ek0_datalik_pd_grad_bwd"]}
            shapes = (tuple(dll.shape), tuple(ll.shape)) + tuple(
                tuple(x.shape) for x in g)
            check(shapes == ((B_MAIN,), (B_MAIN,), (B_MAIN, 2), (B_MAIN, 4),
                             tuple(ys.shape)),
                  f"{label}: shapes dll, ll, d/du0s, d/dps, d/dys {shapes}")
            finite = all(bool(torch.isfinite(x).all()) for x in (dll, ll) + g)
            check(finite, f"{label}: values and gradients finite")
            g_other = pd_grad(odt, prob, u0s, ps, ys, ts, row, not row_calib)
            out[dtype] = (prob, u0s, ps, ys, dll, ll,
                          {row_calib: g, not row_calib: g_other})
        prob64, u64, p64, y64, dll64, ll64, g64 = out[torch.float64]
        dll32, g32 = out[torch.float32][4], out[torch.float32][6]
        err = (dll32.double() - dll64).abs()
        ratio = err / (DL_NATS + DL_REL * dll64.abs())
        member = int(ratio.argmax())
        over = ratio > 1
        text = (f"{row} float32 vs float64 dll, worst member {member}: |diff| "
                f"{float(err[member]):.3e} nats <= {DL_NATS} + {DL_REL} "
                f"|dll64| (dll64 {float(dll64[member]):.6f}), "
                f"{float(ratio[member]):.3f} of the limit; "
                f"{int(over.sum())} members over it "
                f"{torch.nonzero(over).flatten().tolist()[:20]}; the next "
                f"{float(ratio[~over].max()):.3f} of it; largest |diff| "
                f"{float(err.max()):.3e}")
        finite = bool(torch.isfinite(dll32).all())
        if diagonal:
            check(finite and int(over.sum()) <= PD_EK1D_OVER,
                  f"{text}; held: at most {PD_EK1D_OVER} members over it "
                  "(DiagonalEK1's float32 plain covariance), all finite")
        else:
            check(finite and float(ratio[member]) <= 1.0, text)
        for calib in (row_calib, not row_calib):
            gap = ((g32[calib][0].double() - g64[calib][0]).norm(dim=1)
                   + (g32[calib][1].double() - g64[calib][1]).norm(dim=1))
            far = torch.zeros_like(over)
            far[torch.argsort(gap, descending=True)[:10]] = True
            parts = []
            for n, x, y in zip(("u0s", "ps", "ys"), g32[calib], g64[calib]):
                x = x.double()
                text = f"d/d{n} {float((x - y).norm() / y.norm()):.3e}"
                if n != "ys":
                    text += " (" + ", ".join(
                        f"without {what} "
                        f"{float((x - y)[~m].norm() / y[~m].norm()):.3e}"
                        for what, m in (("those over the dll limit", over),
                                        ("the 10 farthest apart", far))) + ")"
                parts.append(text)
            say(f"   {row} float32 vs float64 gradient of sum(dll), calib_grad="
                f"{calib}: relative norm difference {', '.join(parts)}; the "
                f"10 members farthest apart "
                f"{torch.nonzero(far).flatten().tolist()} (reported)")
        case = DataLikPD(B_MAIN, DL_T_MAIN, torch.float64, ts, DL_SPREAD, C,
                         DL_NOISE, diagonal, per_member)
        dll_k, ll_k = case.primal()
        check(torch.equal(dll_k, dll64) and torch.equal(ll_k, ll64),
              f"{row} f64: the front door's values are the primal kernel's")
        st = case.grad_fwd_plain()[2]
        rng = np.random.default_rng(3)
        st_ulp = st * (1 + 2.0 ** -52 * torch.tensor(
            rng.standard_normal(tuple(st.shape)), device=DEVICE))
        for stop in (True, False):
            got = case.grad_bwd(st, stop)
            ref = case.grad_bwd_plain(st, stop)
            moved = case.grad_bwd_plain(st_ulp, stop)
            torch.cuda.synchronize()
            pd_f64_adjoint(f"{row} f64 ek0_datalik_pd_grad_bwd_kernel "
                           f"(calib_grad={not stop}) vs plain at {B_MAIN} x "
                           f"{DL_T_MAIN}", got, ref, moved, case.members)
        del case, st, st_ulp
        # central differences of sum(dll) in ps, float64, along a seeded
        # direction, against the calib_grad=True gradient
        g_full = g64[True]
        rng = np.random.default_rng(7)
        v = torch.tensor(rng.standard_normal(tuple(p64.shape)),
                         device=DEVICE) * p64
        ad = float((g_full[1] * v).sum())
        for eps in (1e-4, 1e-5, 1e-6):
            with torch.no_grad():
                plus, minus = (float(pd_door(odt, prob64, u64, p64 + s * v,
                                             y64, ts, row)[0].sum())
                               for s in (eps, -eps))
            fd = (plus - minus) / (2 * eps)
            r = abs(fd - ad) / abs(ad)
            text = (f"{row} f64 gradient of sum(dll) in ps vs central "
                    f"difference, step {eps:g}: autograd {ad:.9e}, difference "
                    f"{fd:.9e}, relative {r:.3e}")
            if eps == 1e-6:
                check(r <= 1e-6, f"{text} <= 1e-6")
            else:
                say(f"   {text} (reported)")
        del out
        torch.cuda.empty_cache()
    return launches


def pd_bounds(case, T, item):
    """{name: (bound_ms, bound_by, operations per member)} of the three
    per-dimension kernels at B_MAIN members: the bytes each must move (the
    table, the observations, the stream, inputs and outputs once) and the
    plain versions' operations on one member of the same model over T
    steps, times B_MAIN."""
    nq, d, n_p = Q + 1, 2, 4
    ts = dl_times(DL_T_MAIN, "on")
    one = DataLikPD(1, T, torch.float32, ts, DL_SPREAD, *case)
    st1 = one.grad_fwd_plain()[2]
    ops = {"ek0_datalik_pd": ops_of(one.primal_plain),
           "ek0_datalik_pd_grad_fwd": ops_of(one.grad_fwd_plain),
           "ek0_datalik_pd_grad_bwd": ops_of(
               lambda: one.grad_bwd_plain(st1, True))}
    n_obs, d_obs = one.ys.shape[:2]
    V = st1.shape[1]
    per_member_ys = n_obs * d_obs * B_MAIN * item if one.ys.ndim == 3 else 0
    shared = (T * item + 2 * T * 4 + (0 if one.ys.ndim == 3
                                      else n_obs * d_obs * item))
    init = (nq * d + n_p) * B_MAIN * item
    stream = T * V * B_MAIN * item
    outs = 2 * B_MAIN * item
    nbytes = {"ek0_datalik_pd": init + shared + per_member_ys + outs,
              "ek0_datalik_pd_grad_fwd": init + shared + per_member_ys + outs
              + stream,
              "ek0_datalik_pd_grad_bwd": stream + n_p * B_MAIN * item + shared
              + per_member_ys + outs + init + n_obs * d_obs * B_MAIN * item}
    return {name: bound(nbytes[name], ops[name], B_MAIN, 1) + (ops[name],
                                                               nbytes[name])
            for name in PD_NAMES}


def pd_timing(odt, card):
    """Phase 33: float32 at the rows' width: the prey-only and DiagonalEK1
    rows' kernels against their plain versions (`datalik_vs_plain`, strict: the primal and the
    gradient's forward bit for bit; the adjoint by `pd_f32_adjoint`), the
    kernels' times (median of 20 after 3 warm-ups, CUDA events; the
    adjoint with the partial row's calib_grad=False, the other reported)
    of the partial and DiagonalEK1 rows, the doors' candidates/s and
    gradient candidates/s beside the host step table and the Taylor init
    timed alone, and the kernels' bounds. Returns (ms, plain ms, max
    |kernel - plain|, bounds) of the partial row."""
    from odefilters_torch.ops import ek0_datalik as ed

    ts = dl_times(DL_T_MAIN, "on")
    ms_rows = {}
    for row in ("partial", "ek1d"):
        C, diagonal, per_member, _ = PD_ROWS[row]
        case = DataLikPD(B_MAIN, DL_T_MAIN, torch.float32, ts, DL_SPREAD, C,
                         DL_NOISE, diagonal, per_member)
        # the cotangent of dll alone is held at B_CHECK (phase 31)
        e, pm = datalik_vs_plain(f"f32 {row} at {B_MAIN} x {DL_T_MAIN}", case,
                                 1e-4, 1e-6, hold_grads=False, strict=True,
                                 dll_only_too=False)
        if row == "partial":
            err, p_ms = e, pm
        st = case.grad_fwd()[2]
        ms = {"ek0_datalik_pd": time_ms(case.primal, warmup=3, iters=20),
              "ek0_datalik_pd_grad_fwd": time_ms(case.grad_fwd, warmup=3,
                                                 iters=20),
              "ek0_datalik_pd_grad_bwd": time_ms(
                  lambda: case.grad_bwd(st, True), warmup=3, iters=20)}
        ms_full = time_ms(lambda: case.grad_bwd(st, False), warmup=3,
                          iters=20)
        say(f"   {row}: " + ", ".join(f"{n} kernel {ms[n]:.4f} ms"
                                      for n in PD_NAMES)
            + f" (calib_grad=True: {ms_full:.4f} ms) (card: {card})")
        ms_rows[row] = ms
        del case, st
        torch.cuda.empty_cache()
    for name in PD_NAMES:
        say(f"   {name}: plain {p_ms[name]:.1f} ms (partial row)")
    for row in ("partial", "ek1d"):
        C, diagonal, per_member, row_calib = PD_ROWS[row]
        prob, u0s, ps, ys = dl_inputs(B_MAIN, torch.float32, ts, DL_SPREAD)
        ys = pd_obs(ys, ts, C, B_MAIN, per_member)

        def primal():
            with torch.no_grad():
                pd_door(odt, prob, u0s, ps, ys, ts, row)

        def table():
            ed.data_table(DL_TSPAN, DL_T_MAIN, ts, Q, torch.float32, DEVICE)

        def init():
            with torch.no_grad():
                ed.initial_means(prob.f, u0s, ps, DL_TSPAN, DL_T_MAIN, Q)

        t_ms = time_ms(table, warmup=3, iters=20)
        i_ms = time_ms(init, warmup=3, iters=20)
        d_ms = time_ms(primal, warmup=3, iters=20)
        g_ms = time_ms(lambda: pd_grad(odt, prob, u0s, ps, ys, ts, row,
                                       row_calib), warmup=3, iters=20)
        say(f"   {row} float32 ensemble_data_loglik: {d_ms:.3f} ms = "
            f"{B_MAIN / d_ms * 1e3:.0f} candidates/s; forward + backward of "
            f"sum(dll) (calib_grad={row_calib}): {g_ms:.3f} ms = "
            f"{B_MAIN / g_ms * 1e3:.0f} gradient candidates/s; of the primal "
            f"door: the step table's host build {t_ms:.3f} ms, the Taylor "
            f"init {i_ms:.3f} ms, the kernel "
            f"{ms_rows[row]['ek0_datalik_pd']:.4f} ms")
    C, diagonal, per_member, _ = PD_ROWS["partial"]
    bounds = pd_bounds((C, DL_NOISE, diagonal, per_member), DL_T_MAIN, 4)
    for name in PD_NAMES:
        b_ms, b_by, ops, nbytes = bounds[name]
        say(f"   {name}: {ops} operations per member over {DL_T_MAIN} steps; "
            f"{nbytes / 1e6:.1f} MB; bound {b_ms:.4f} ms by {b_by}")
    return ms_rows["partial"], p_ms, err, {n: b[:3] for n, b in bounds.items()}


def pd_phases(odt, card, built):
    """Phases 31-33. Returns (launches on the main path's runs, ms, plain
    ms, max |kernel - plain|, bounds) of the three per-dimension kernels."""
    say(f"== 31. the per-dimension data-likelihood kernels vs plain, "
        f"B={B_CHECK}, LV over {DL_TSPAN}, T={DL_T_CHECK}, 3 observations, "
        "EK0 and DiagonalEK1, shared and per-member data, float64 and "
        "float32, calib_grad both ways")
    pd_check()
    say(f"== 32. the per-dimension path: ensemble_data_loglik, B={B_MAIN}, "
        f"LV over {DL_TSPAN}, T={DL_T_MAIN}, 9 observations: prey only, "
        "DiagonalEK1, per-member data")
    launches = pd_path(odt)
    say(f"== 33. the per-dimension kernels vs plain and timing, float32, "
        f"B={B_MAIN}, T={DL_T_MAIN}")
    ms, p_ms, err, bounds = pd_timing(odt, card)
    # the adjoint as the main path ran it: the partial row's gradient,
    # calib_grad=False
    err["ek0_datalik_pd_grad_bwd"] = err["ek0_datalik_pd_grad_bwd "
                                         "calib_grad=False"]
    # the path's instantiations: float32, Lotka-Volterra
    print_registers(built["log"], PD_NAMES, only="LotkaVolterraIf")
    return launches, ms, p_ms, err, bounds


# The dense EK1 data likelihood (phases 34-36): the JAX package's row
# tpu_datalik_ek1_pallas (benchmarks/run_all.py:739-752, 836-846, "the
# stiff-inference configuration"): Lotka-Volterra over (0, 3),
# EK1(order=3), 8192 candidates with parameters scaled by U(0.8, 1.2), 120
# steps, the 9 on-grid observations of the full state with noise std 0.05; and the
# same with per-member observations.
EK1_NAMES = ("ek1_datalik", "ek1_datalik_grad_fwd", "ek1_datalik_grad_bwd")
# The check phase: 3 observations at steps 8, 20 and 32 of T = 40, three
# observation models: a dense C (a full-state one would hide a transposed
# C) with noise (0.1, 0.2) (a scalar one would hide a transposed R), the
# full state with scalar noise 0.05, and C = [[2, 0]] (d_obs = 1, a scale of
# 1 would hide a missing one).
EK1_CHECK_MODELS = {
    "C=[[1,0],[1,1]] r=(0.1,0.2)": (np.array([[1.0, 0.0], [1.0, 1.0]]),
                                    np.array([0.1, 0.2])),
    "full r=0.05": (None, 0.05),
    "C=[[2,0]] r=0.1": (np.array([[2.0, 0.0]]), 0.1)}
# The check's cases (model, per-member data) in float64; float32 runs the
# first (its adjoint held against the float64 run's, PD_F32_FACTOR).
EK1_CHECK_CASES = (("C=[[1,0],[1,1]] r=(0.1,0.2)", True),
                   ("full r=0.05", False),
                   ("C=[[2,0]] r=0.1", True))
# The path's rows: per-member data or not; the full state, noise 0.05.
EK1_ROWS = {"full": False, "per_member": True}


class DataLikEK1(DataLikPD):
    """The dense EK1 data likelihood's kernel arguments for one ensemble
    (as the front door makes them), seeded cotangents, and both versions of
    its three kernels. The plain versions take the problem's Jacobian (in
    the CUDA field's order of operations); the kernels evaluate the
    field's own."""

    NAMES = EK1_NAMES
    TIMED_STOP = True  # the row's gradient: calib_grad=False

    def __init__(self, B, T, dtype, ts, spread, C, noise, per_member):
        from odefilters_torch.ops import ek0_datalik as ed
        from odefilters_torch.ops import ek1_datalik as e1d

        self.e1d = e1d
        self.spec = (B, T, ts, spread, C, noise, per_member)
        self.keep, self.twin = None, None
        self.prob, u0s, ps, ys = dl_inputs(B, dtype, ts, spread)
        ys = pd_obs(ys, ts, C, B, per_member)
        self.m0_p, self.ps, self.ys, self.table, self.consts = \
            ed.ek1_kernel_inputs(self.prob.f, u0s, ps, DL_TSPAN, T, ts, ys,
                                 noise, Q, obs_matrix=C)
        self.members = (True, True, per_member)
        rng = np.random.default_rng(1)
        self.cts = [torch.tensor(rng.standard_normal(B), dtype=dtype,
                                 device=DEVICE) for _ in range(2)]

    def _plain(self):
        return self.prob.f, self.prob.jac

    def primal(self):
        return self.e1d.ek1_datalik(*self._plain(), self.prob.field,
                                    self.m0_p, self.ps, self.ys, self.table,
                                    **self.consts)

    def primal_plain(self):
        return self.e1d.ek1_datalik_plain(*self._plain(), self.m0_p, self.ps,
                                          self.ys, self.table, **self.consts)

    def grad_fwd(self):
        return self.e1d.ek1_datalik_grad_fwd(
            *self._plain(), self.prob.field, self.m0_p, self.ps, self.ys,
            self.table, **self.consts)

    def grad_fwd_plain(self):
        return self.e1d.ek1_datalik_fwd_stream_plain(
            *self._plain(), self.m0_p, self.ps, self.ys, self.table,
            **self.consts)

    def grad_bwd(self, st, stop_calib, dll_only=False):
        return self.e1d.ek1_datalik_grad_bwd(
            *self._plain(), self.prob.field, st, self.ps, self.ys,
            *self._cts(dll_only), self.table, nq=Q + 1,
            stop_calib=stop_calib, **self.consts)

    def grad_bwd_plain(self, st, stop_calib, dll_only=False):
        dm0, dps, part = self.e1d.ek1_datalik_grad_bwd_plain(
            *self._plain(), st, self.ps, self.ys, *self._cts(dll_only),
            self.table, nq=Q + 1, stop_calib=stop_calib, **self.consts)
        return dm0, dps, part if self.ys.ndim == 3 else torch.sum(part, -1)


def ek1dl_check():
    """Phase 34: the three dense EK1 kernels against their plain versions at
    B_CHECK members, T = DL_T_CHECK, 3 observations, each case of
    EK1_CHECK_CASES in float64 and the first in float32
    (`datalik_vs_plain`, strict: the primal and the gradient's forward bit
    for bit, NaN members alike; the float64 adjoint by `dl_hold_grads`,
    the float32 by `pd_f32_adjoint`)."""
    ts = PD_CHECK_STEPS * (DL_TSPAN[1] - DL_TSPAN[0]) / DL_T_CHECK
    for dtype, rtol, atol, cases in (
            (torch.float64, 1e-10, 1e-12, EK1_CHECK_CASES),
            (torch.float32, 1e-4, 1e-6, EK1_CHECK_CASES[:1])):
        for model, per_member in cases:
            C, noise = EK1_CHECK_MODELS[model]
            label = (f"{str(dtype).replace('torch.', '')} EK1 {model} "
                     f"{'per-member' if per_member else 'shared'} ys")
            case = DataLikEK1(B_CHECK, DL_T_CHECK, dtype, ts, DL_SPREAD_CHECK,
                              C, noise, per_member)
            datalik_vs_plain(label, case, rtol, atol,
                             hold_grads=dtype == torch.float64, strict=True)


def ek1dl_door(odt, prob, u0s, ps, ys, ts, calib_grad=True):
    return odt.ensemble_data_loglik(
        prob.f, u0s, ps, DL_TSPAN, DL_T_MAIN, ts, ys, DL_NOISE,
        field=prob.field, ek1=True, jac=prob.jac, calib_grad=calib_grad)


def ek1dl_grad(odt, prob, u0s, ps, ys, ts, calib_grad):
    """Gradient of sum(dll) in (u0s, ps, ys) through the front door."""
    args = [x.clone().requires_grad_() for x in (u0s, ps, ys)]
    dll, _ = ek1dl_door(odt, prob, *args, ts, calib_grad)
    return torch.autograd.grad(dll.sum(), args)


def ek1dl_path(odt):
    """Phase 35: the front door with ek1=True at the rows of EK1_ROWS,
    float32 and float64, each run with the counts set to 0 before it and
    read after it: launches 1/0/0 for the primal, 0/1/1 for the gradient of
    sum(dll) in (u0s, ps, ys) with calib_grad=False (the gradient the
    float32 users take); shapes and finite values and gradients;
    float32 against float64 on the worst member (DL_NATS + DL_REL |dll|)
    and the float32 gradients' relative norm difference from float64 with
    calib_grad both ways (reported); the float64 door's values equal to the
    primal kernel's; the float64 gradient (calib_grad=True) against central
    differences of sum(dll) in ps. Returns the float32 full row's
    launches."""
    launches = {}
    ts = dl_times(DL_T_MAIN, "on")
    for row, per_member in EK1_ROWS.items():
        out = {}
        for dtype in (torch.float32, torch.float64):
            label = f"{str(dtype).replace('torch.', '')} EK1 {row}"
            prob, u0s, ps, ys = dl_inputs(B_MAIN, dtype, ts, DL_SPREAD)
            ys = pd_obs(ys, ts, None, B_MAIN, per_member)
            reset_counts()
            with torch.no_grad():
                dll, ll = ek1dl_door(odt, prob, u0s, ps, ys, ts)
            torch.cuda.synchronize()
            c_primal = read_counts(*EK1_NAMES)
            reset_counts()
            g = ek1dl_grad(odt, prob, u0s, ps, ys, ts, False)
            torch.cuda.synchronize()
            c_grad = read_counts(*EK1_NAMES)
            check(tuple(c_primal.values()) == (1, 0, 0)
                  and tuple(c_grad.values()) == (0, 1, 1),
                  f"{label}: launches in the primal run {c_primal}, in the "
                  f"gradient run (calib_grad=False) {c_grad} (1/0/0 and "
                  "0/1/1)")
            if dtype == torch.float32 and row == "full":
                launches = {"ek1_datalik": c_primal["ek1_datalik"],
                            "ek1_datalik_grad_fwd":
                                c_grad["ek1_datalik_grad_fwd"],
                            "ek1_datalik_grad_bwd":
                                c_grad["ek1_datalik_grad_bwd"]}
            shapes = (tuple(dll.shape), tuple(ll.shape)) + tuple(
                tuple(x.shape) for x in g)
            check(shapes == ((B_MAIN,), (B_MAIN,), (B_MAIN, 2), (B_MAIN, 4),
                             tuple(ys.shape)),
                  f"{label}: shapes dll, ll, d/du0s, d/dps, d/dys {shapes}")
            g_full = ek1dl_grad(odt, prob, u0s, ps, ys, ts, True)
            finite = all(bool(torch.isfinite(x).all())
                         for x in (dll, ll) + g + g_full)
            check(finite, f"{label}: values and gradients finite")
            out[dtype] = (prob, u0s, ps, ys, dll, ll,
                          {False: g, True: g_full})
        prob64, u64, p64, y64, dll64, ll64, g64 = out[torch.float64]
        dll32, g32 = out[torch.float32][4], out[torch.float32][6]
        err = (dll32.double() - dll64).abs()
        ratio = err / (DL_NATS + DL_REL * dll64.abs())
        member = int(ratio.argmax())
        check(bool(torch.isfinite(dll32).all()) and float(ratio[member]) <= 1,
              f"EK1 {row} float32 vs float64 dll, worst member {member}: "
              f"|diff| {float(err[member]):.3e} nats <= {DL_NATS} + {DL_REL} "
              f"|dll64| (dll64 {float(dll64[member]):.6f}), "
              f"{float(ratio[member]):.3f} of the limit; largest |diff| "
              f"{float(err.max()):.3e}")
        for calib in (False, True):
            text = ", ".join(
                f"d/d{n} {float((x.double() - y).norm() / y.norm()):.3e}"
                for n, x, y in zip(("u0s", "ps", "ys"), g32[calib],
                                   g64[calib]))
            say(f"   EK1 {row} float32 vs float64 gradient of sum(dll), "
                f"calib_grad={calib}: relative norm difference {text} "
                "(reported)")
        case = DataLikEK1(B_MAIN, DL_T_MAIN, torch.float64, ts, DL_SPREAD,
                          None, DL_NOISE, per_member)
        dll_k, ll_k = case.primal()
        check(torch.equal(dll_k, dll64) and torch.equal(ll_k, ll64),
              f"EK1 {row} f64: the front door's values are the primal "
              "kernel's")
        del case
        # central differences of sum(dll) in ps, float64, along a seeded
        # direction, against the calib_grad=True gradient
        rng = np.random.default_rng(7)
        v = torch.tensor(rng.standard_normal(tuple(p64.shape)),
                         device=DEVICE) * p64
        ad = float((g64[True][1] * v).sum())
        for eps in (1e-4, 1e-5, 1e-6):
            with torch.no_grad():
                plus, minus = (float(ek1dl_door(odt, prob64, u64, p64 + s * v,
                                              y64, ts)[0].sum())
                               for s in (eps, -eps))
            fd = (plus - minus) / (2 * eps)
            r = abs(fd - ad) / abs(ad)
            text = (f"EK1 {row} f64 gradient of sum(dll) in ps vs central "
                    f"difference, step {eps:g}: autograd {ad:.9e}, difference "
                    f"{fd:.9e}, relative {r:.3e}")
            if eps == 1e-6:
                check(r <= 1e-6, f"{text} <= 1e-6")
            else:
                say(f"   {text} (reported)")
        del out
        torch.cuda.empty_cache()
    return launches


def ek1dl_bounds(case, st, item):
    """{name: (bound_ms, bound_by, operations per member)} of the three
    EK1 kernels at ``case``'s members: the bytes each must move (the table,
    the observations, the stream, inputs and outputs once) and the plain
    versions' operations on one member of the same model, counted on a
    one-step table without and with an observation and weighted by this
    schedule's steps of each kind."""
    from odefilters_torch.ops import ek0_datalik as ed

    nq, d, n_p = Q + 1, 2, 4
    B, T = case.m0_p.shape[2], case.table.n_steps
    n_obs, d_obs = case.ys.shape[:2]
    one = DataLikEK1(1, T, torch.float32, *case.spec[2:])
    all_ys = one.ys
    dt = (DL_TSPAN[1] - DL_TSPAN[0]) / T
    ops = {n: 0 for n in EK1_NAMES}
    for seg, count in (((1,), T - n_obs), ((1, 0), n_obs)):
        one.table = ed.step_table(DL_TSPAN[0], dt, Q, torch.float32, DEVICE,
                                  seg_lens=seg)
        one.ys = all_ys[:len(seg) - 1].contiguous()
        st1 = one.grad_fwd_plain()[2]
        ops["ek1_datalik"] += count * ops_of(one.primal_plain)
        ops["ek1_datalik_grad_fwd"] += count * ops_of(one.grad_fwd_plain)
        ops["ek1_datalik_grad_bwd"] += count * ops_of(
            lambda: one.grad_bwd_plain(st1, True))
    V = st.shape[1]
    per_member_ys = n_obs * d_obs * B * item if case.ys.ndim == 3 else 0
    shared = (T * item + 2 * T * 4 + (0 if case.ys.ndim == 3
                                      else n_obs * d_obs * item))
    init = (nq * d + n_p) * B * item
    stream = T * V * B * item
    outs = 2 * B * item
    nbytes = {"ek1_datalik": init + shared + per_member_ys + outs,
              "ek1_datalik_grad_fwd": init + shared + per_member_ys + outs
              + stream,
              "ek1_datalik_grad_bwd": stream + n_p * B * item + shared
              + per_member_ys + outs + init + n_obs * d_obs * B * item}
    return {name: bound(nbytes[name], ops[name], B, 1) + (ops[name],
                                                          nbytes[name])
            for name in EK1_NAMES}


def ek1dl_timing(odt, card):
    """Phase 36: float32 at the rows' width: the full-state row's kernels
    against their plain versions (`datalik_vs_plain`, strict: the primal
    and the gradient's forward bit for bit; the adjoint by `pd_f32_adjoint`
    with the row's calib_grad=False, the gradient the path takes: phase 34 holds
    calib_grad=True at B_CHECK), the full row's kernel times on the same
    case (median of 20 after 3 warm-ups, CUDA events; the adjoint with
    calib_grad=False, the other reported), the door's candidates/s and
    gradient candidates/s beside the host step table and the Taylor init
    timed alone, and the kernels' bounds. Returns (ms, plain ms, max
    |kernel - plain|, bounds) of the full row."""
    from odefilters_torch.ops import ek0_datalik as ed

    ts = dl_times(DL_T_MAIN, "on")
    case = DataLikEK1(B_MAIN, DL_T_MAIN, torch.float32, ts, DL_SPREAD, None,
                      DL_NOISE, EK1_ROWS["full"])
    # the cotangent of dll alone is held at B_CHECK (phase 34)
    err, p_ms = datalik_vs_plain(f"f32 EK1 full at {B_MAIN} x {DL_T_MAIN}",
                                 case, 1e-4, 1e-6, hold_grads=False,
                                 strict=True, stops=(case.TIMED_STOP,),
                                 dll_only_too=False)
    st = case.grad_fwd()[2]
    ms = {"ek1_datalik": time_ms(case.primal, warmup=3, iters=20),
          "ek1_datalik_grad_fwd": time_ms(case.grad_fwd, warmup=3, iters=20),
          "ek1_datalik_grad_bwd": time_ms(lambda: case.grad_bwd(st, True),
                                          warmup=3, iters=20)}
    ms_full = time_ms(lambda: case.grad_bwd(st, False), warmup=1, iters=5)
    for n in EK1_NAMES:
        say(f"   {n} kernel {ms[n]:.4f} ms, plain (once) {p_ms[n]:.1f} ms "
            f"(card: {card})")
    say(f"   ek1_datalik_grad_bwd kernel with calib_grad=True "
        f"{ms_full:.4f} ms")
    prob, u0s, ps, ys = dl_inputs(B_MAIN, torch.float32, ts, DL_SPREAD)

    def primal():
        with torch.no_grad():
            ek1dl_door(odt, prob, u0s, ps, ys, ts)

    def table():
        ed.data_table(DL_TSPAN, DL_T_MAIN, ts, Q, torch.float32, DEVICE)

    def init():
        with torch.no_grad():
            ed.initial_means(prob.f, u0s, ps, DL_TSPAN, DL_T_MAIN, Q)

    t_ms = time_ms(table, warmup=3, iters=20)
    i_ms = time_ms(init, warmup=3, iters=20)
    d_ms = time_ms(primal, warmup=3, iters=20)
    g_ms = time_ms(lambda: ek1dl_grad(odt, prob, u0s, ps, ys, ts, False),
                   warmup=3, iters=20)
    say(f"   EK1 float32 ensemble_data_loglik: {d_ms:.3f} ms = "
        f"{B_MAIN / d_ms * 1e3:.0f} candidates/s; forward + backward of "
        f"sum(dll) (calib_grad=False): {g_ms:.3f} ms = "
        f"{B_MAIN / g_ms * 1e3:.0f} gradient candidates/s; of the primal "
        f"door: the step table's host build {t_ms:.3f} ms, the Taylor init "
        f"{i_ms:.3f} ms, the kernel {ms['ek1_datalik']:.4f} ms")
    bounds = ek1dl_bounds(case, st, 4)
    for n in EK1_NAMES:
        b_ms, b_by, ops, nbytes = bounds[n]
        say(f"   {n}: {ops} operations per member over {DL_T_MAIN} steps; "
            f"{nbytes / 1e6:.1f} MB; bound {b_ms:.4f} ms by {b_by}")
    del case, st
    torch.cuda.empty_cache()
    return ms, p_ms, err, {n: b[:3] for n, b in bounds.items()}


def ek1dl_phases(odt, card, built):
    """Phases 34-36. Returns (launches on the main path's runs, ms, plain
    ms, max |kernel - plain|, bounds) of the three dense EK1 kernels."""
    say(f"== 34. the dense EK1 data-likelihood kernels vs plain, "
        f"B={B_CHECK}, LV over {DL_TSPAN}, T={DL_T_CHECK}, 3 observations, "
        "dense C, full state, C = [[2, 0]], shared and per-member data, "
        "float64 and float32, calib_grad both ways")
    ek1dl_check()
    say(f"== 35. the dense EK1 path: ensemble_data_loglik(ek1=True), "
        f"B={B_MAIN}, LV over {DL_TSPAN}, T={DL_T_MAIN}, 9 observations of "
        "the full state: shared and per-member data")
    launches = ek1dl_path(odt)
    say(f"== 36. the dense EK1 kernels vs plain and timing, float32, "
        f"B={B_MAIN}, T={DL_T_MAIN}")
    ms, p_ms, err, bounds = ek1dl_timing(odt, card)
    # the adjoint as the main path ran it: calib_grad=False
    err["ek1_datalik_grad_bwd"] = err["ek1_datalik_grad_bwd calib_grad=False"]
    # the path's instantiations: float32, Lotka-Volterra
    print_registers(built["log"], EK1_NAMES, only="LotkaVolterraIf")
    return launches, ms, p_ms, err, bounds


# -- the Kron-grid PDE solves (phases 37-39) --------------------------------

KG_NAMES = ("ek0_kron_grid", "ek1d_kron_grid")
# phase 37: several CTAs and a partial last one (1369 points, 11 CTAs)
KG_N_CHECK, KG_T_CHECK, KG_SE_CHECK, KG_DT_CHECK = 37, 200, 10, 1e-5
# DiagonalEK1 on grids larger than its cluster's threads, 40 steps each:
# N = 100 (10,000 points, 79 blocks: 5 a CTA, 2 points a thread) and N =
# 120 (14,400 points, 113 blocks: 8 a CTA, 4 points a thread, the last CTAs
# partial or empty), and on one larger than the cluster holds (N = 160,
# 25,600 points > 16 x 384 x 4 = 24,576: the cooperative kernel, 200 CTAs
# of 128)
KG_N_BIG, KG_N_COOP, KG_T_BIG = (100, 120), 160, 40
# phases 38-39: the JAX package's rows (benchmarks/run_all.py), d = 9800
KG_N, KG_T, KG_SE, KG_TSPAN, KG_ALPHA = 70, 1000, 50, (0.0, 0.01), 0.1
# float64 means against DOP853 (rtol 1e-10, atol 1e-12): the CPU plain path
# misses it by 3.8e-11 (EK0) and 3.79e-11 (DiagonalEK1), the reference's own
# accuracy
KG_DOP853_LIMIT = 1e-9
# float32 against float64 means at the worst point (CPU plain: 3.04e-5,
# 3.06e-5)
KG_F32_US_LIMIT = 1e-4
# float32 stds: no float32 std of either solve has a correct digit. The
# float32 covariance sits on its rounding floor: EK0's scalar variance
# clamps to 0 on every saved row, DiagonalEK1's stds are ~2e-9 at every
# point, 5.4e3 .. 9.1e5 times float64's (the calibration sees rounding
# noise at dt = 1e-5). What is held: |std32 - std64| <= KG_F32_STD_LIMIT at
# every saved point, about a 24th of a float32 ulp of the largest mean
# (3.37). CPU plain: max |dstd| 6.02e-13 (EK0), 2.011e-9 (DiagonalEK1). The
# DiagonalEK1 points over it at any saved row, or with a float32 variance
# not finite, are counted and held at KG_EK1D_OVER (CPU plain: 0 of 9800).
KG_F32_STD_LIMIT, KG_EK1D_OVER = 1e-8, 0


class KronGrid:
    """One Kron-grid solve of the Brusselator: the door's Taylor init, the
    wrapper's arguments, and both versions of its kernel."""

    def __init__(self, ek1d, N, T, save_every, dtype, dt):
        from odefilters_torch.models import library as lib
        from odefilters_torch.ops import kron_grid as kg

        self.kg, self.ek1d, self.N, self.T = kg, ek1d, N, T
        tspan = (0.0, T * dt)
        self.m0 = kg.brusselator_init(N, tspan, Q, KG_ALPHA, dtype,
                                      device=DEVICE)
        self.f, self.jd = (lib.brusselator_2d_f_grids(N),
                           lib.brusselator_2d_jd_grids(N))
        self.args = (self.m0, KG_ALPHA, 0.0, dt, T, Q, save_every)
        _, At, Qt, self.m0_p, pinv0, pinv1 = kg.kron_inputs(
            self.m0, dt, T, Q, save_every)
        self.plain_kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=0.0,
                             dt=dt, n_steps=T, save_every=save_every)

    def kernel(self):
        """The wrapper's launch."""
        kw = dict(field="brusselator_2d")
        if self.ek1d:
            return self.kg.ek1d_kron_grid_solve(self.f, self.jd, *self.args,
                                                **kw)
        return self.kg.ek0_kron_grid_solve(self.f, *self.args, **kw)

    def plain(self, T=None):
        kw = dict(self.plain_kw)
        if T is not None:
            kw.update(n_steps=T, save_every=1)
        if self.ek1d:
            return self.kg.ek1d_kron_grid_solve_plain(
                self.f, self.jd, self.m0_p, KG_ALPHA, **kw)
        return self.kg.ek0_kron_grid_solve_plain(self.f, self.m0_p,
                                                 KG_ALPHA, **kw)


def kron_route(case):
    """The kernel DiagonalEK1's launch runs at ``case``'s grid, as its C
    entry picks it: "cluster" or "cooperative"."""
    from odefilters_torch.ops import _build

    on = _build.load().ek1d_kron_grid_on_cluster(case.N, case.N)
    return "cluster" if on else "cooperative"


def kron_vs_plain(label, case):
    """The kernel against its plain version on the same inputs: us, var and
    ll bit for bit (checked), one launch. Returns (max |kernel - plain|,
    the plain version's milliseconds)."""
    name = KG_NAMES[case.ek1d]
    ref, p_ms = once(case.plain)
    err = 0.0
    reset_counts()
    got = case.kernel()
    torch.cuda.synchronize()
    n = read_counts(name)[name]
    at = f"{label} ({kron_route(case)})" if case.ek1d else label
    check(n == 1, f"{at} {name}: {n} launch(es), expected 1")
    for what, g, r in zip(("us", "var", "ll"), got, ref):
        finite = bool(torch.isfinite(g).all())
        check(finite, f"{at} {name}_kernel, {what}: finite")
        bitwise(f"{at} {name}_kernel, {what}", g, r, strict=True)
        err = max(err, float((g.double() - r.double()).abs().max()))
    return err, p_ms


def brusselator_rhs(N, alpha):
    """The flat 2-D Brusselator in numpy, independent of the port: periodic
    Laplacian scaled by (N-1)^2, A = 3.4, B = 1."""
    A, B, scale = 3.4, 1.0, float((N - 1) ** 2)

    def lap(x):
        return (np.roll(x, 1, 0) + np.roll(x, -1, 0) + np.roll(x, 1, 1)
                + np.roll(x, -1, 1) - 4.0 * x) * scale

    def f(t, y):
        a, b = y[:N * N].reshape(N, N), y[N * N:].reshape(N, N)
        da = B + a * a * b - (A + 1.0) * a + alpha * lap(a)
        db = A * a - a * a * b + alpha * lap(b)
        return np.concatenate([da.ravel(), db.ravel()])

    return f


def kron_path(odt):
    """Phase 38: the two front doors at the JAX rows, float32 and float64,
    each run with the counts set to 0 before it and read after it. Returns
    the float32 doors' launches."""
    from scipy.integrate import solve_ivp

    from odefilters_torch.models.library import brusselator_2d_u0

    N, T, SE = KG_N, KG_T, KG_SE
    S1 = T // SE + 1
    ts = np.linspace(*KG_TSPAN, S1)
    ref = solve_ivp(brusselator_rhs(N, KG_ALPHA), KG_TSPAN,
                    brusselator_2d_u0(N), method="DOP853", t_eval=ts,
                    rtol=1e-10, atol=1e-12)
    check(ref.status == 0, f"DOP853 reference: status {ref.status}, "
          f"{ref.nfev} evaluations")
    ref_us = ref.y.T.reshape(S1, 2, N, N)
    launches = {}
    for ek1d, door in ((False, odt.solve_brusselator_ek0),
                       (True, odt.solve_brusselator_ek1d)):
        name = KG_NAMES[ek1d]
        out = {}
        for dtype in (torch.float32, torch.float64):
            label = f"{str(dtype)[6:]} {door.__name__}"
            reset_counts()
            us, var, ll = door(N, KG_TSPAN, T, save_every=SE, dtype=dtype)
            torch.cuda.synchronize()
            n = read_counts(name)[name]
            if dtype == torch.float32:
                launches[name] = n
            var_shape = (S1, 2, N, N) if ek1d else (S1,)
            check(n == 1 and tuple(us.shape) == (S1, 2, N, N)
                  and tuple(var.shape) == var_shape and ll.ndim == 0,
                  f"{label}: {n} launch(es) of {name}, us "
                  f"{tuple(us.shape)}, var {tuple(var.shape)}")
            finite = all(bool(torch.isfinite(x).all()) for x in (us, var, ll))
            check(finite and bool((var >= 0).all()),
                  f"{label}: finite us, var, ll; var >= 0")
            say(f"   {label}: ll {float(ll):.9g} (reported)")
            out[dtype] = [x.double().cpu().numpy() for x in (us, var, ll)]
        us64, var64, _ = out[torch.float64]
        us32, var32, _ = out[torch.float32]
        e = float(np.abs(us64 - ref_us).max())
        check(e <= KG_DOP853_LIMIT, f"f64 {door.__name__} means vs DOP853: "
              f"max |dus| {e:.3e} <= {KG_DOP853_LIMIT:g}")
        dus = np.abs(us32 - us64)
        at = np.unravel_index(int(dus.argmax()), dus.shape)
        check(float(dus.max()) <= KG_F32_US_LIMIT,
              f"{door.__name__} f32 vs f64 means: max |dus| "
              f"{float(dus.max()):.3e} <= {KG_F32_US_LIMIT:g} (worst point "
              f"row, species, i, j = {tuple(int(x) for x in at)})")
        sd32, sd64 = np.sqrt(var32[1:]), np.sqrt(var64[1:])
        dsd = np.abs(sd32 - sd64).reshape(S1 - 1, -1)
        ratio = np.median((sd32 / sd64).reshape(S1 - 1, -1), axis=1)
        say(f"   {door.__name__} stds: f64 {sd64.min():.3e} .. "
            f"{sd64.max():.3e}, f32 {sd32.min():.3e} .. {sd32.max():.3e}; "
            f"f32 variance clamped to 0 at {int((var32[1:] <= 0).sum())} of "
            f"{var32[1:].size} saved values; the median f32 / f64 std ratio "
            f"per row {float(ratio.min()):.4g} .. {float(ratio.max()):.4g} "
            "(reported: the float32 covariance sits on its rounding floor, "
            "no float32 std has a correct digit)")
        if ek1d:
            over = (dsd > KG_F32_STD_LIMIT).any(axis=0) | (
                ~np.isfinite(var32[1:])).reshape(S1 - 1, -1).any(axis=0)
            n_over = int(over.sum())
            check(n_over <= KG_EK1D_OVER,
                  f"DiagonalEK1 f32 vs f64 stds: max |dstd| "
                  f"{float(dsd.max()):.3e}; {n_over} of {2 * N * N} points "
                  f"over {KG_F32_STD_LIMIT:g} at some saved row, or not "
                  f"finite <= {KG_EK1D_OVER}")
        else:
            check(float(dsd.max()) <= KG_F32_STD_LIMIT,
                  f"EK0 f32 vs f64 stds: max |dstd| {float(dsd.max()):.3e} "
                  f"<= {KG_F32_STD_LIMIT:g}")
    return launches


def kron_bounds(case, item):
    """(bound_ms, bound_by, operations per step, bytes) of ``case``'s kernel:
    its input (the initial means) read once and its outputs written once,
    and its plain version's operations per step over the whole grid."""
    us, var, _ = case.plain(T=1)
    nbytes = (case.m0.numel() + (case.T // case.plain_kw["save_every"] + 1)
              * (us[0].numel() + var[0].numel()) + 1) * item
    ops = count_ops(lambda T1: lambda: case.plain(T=T1))
    return bound(nbytes, ops, 1, case.T) + (ops, nbytes)


def kron_timing(odt, card):
    """Phase 39: float32 at the rows' width: each kernel against its plain
    version (run once, bit for bit), the kernel's and the door's times
    (median of 20 after 3 warm-ups, CUDA events), the Taylor init alone,
    steps/s, the bound, and the 2 T grid barriers alone as a latency floor.
    Returns (ms, plain ms, max |kernel - plain|, bounds)."""
    import ctypes

    from odefilters_torch.ops import _build
    from odefilters_torch.ops import kron_grid as kg

    ms, p_ms, err, bounds = {}, {}, {}, {}
    dt = (KG_TSPAN[1] - KG_TSPAN[0]) / KG_T
    nb = -(-KG_N * KG_N // kg.KRON_BLOCK)
    lib = _build.load()

    def barriers():
        rc = lib.kron_grid_sync_probe(
            nb, 2 * KG_T, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"kron_grid_sync_probe: CUDA error {rc}")

    floor_ms = time_ms(barriers, warmup=3, iters=20)

    def cluster_barriers():
        threads = min(-(-nb // kg.KRON_CLUSTER), 3) * kg.KRON_BLOCK
        rc = lib.kron_cluster_sync_probe(
            threads, 2 * KG_T,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"kron_cluster_sync_probe: CUDA error {rc}")

    c_floor = time_ms(cluster_barriers, warmup=3, iters=20)
    say(f"   {2 * KG_T} cluster barriers alone ({kg.KRON_CLUSTER} CTAs): "
        f"{c_floor:.4f} ms (card: {card})")
    i_ms = time_ms(lambda: kg.brusselator_init(KG_N, KG_TSPAN, Q, KG_ALPHA,
                                               torch.float32, device=DEVICE),
                   warmup=3, iters=20)
    say(f"   {2 * KG_T} grid barriers of {nb} CTAs alone: {floor_ms:.4f} ms "
        f"(card: {card}); the Taylor init alone: {i_ms:.3f} ms")
    for ek1d, door in ((False, odt.solve_brusselator_ek0),
                       (True, odt.solve_brusselator_ek1d)):
        name = KG_NAMES[ek1d]
        case = KronGrid(ek1d, KG_N, KG_T, KG_SE, torch.float32, dt)
        err[name], p_ms[name] = kron_vs_plain(
            f"f32 at N={KG_N} x {KG_T}", case)
        ms[name] = time_ms(case.kernel, warmup=3, iters=20)
        d_ms = time_ms(lambda: door(KG_N, KG_TSPAN, KG_T, save_every=KG_SE,
                                    dtype=torch.float32),
                       warmup=3, iters=20)
        b_ms, b_by, ops, nbytes = kron_bounds(case, 4)
        bounds[name] = (b_ms, b_by, ops)
        say(f"   {name} kernel {ms[name]:.4f} ms = "
            f"{KG_T / ms[name] * 1e3:.0f} steps/s, plain (once) "
            f"{p_ms[name]:.1f} ms (card: {card})")
        say(f"   {door.__name__} (Taylor init + kernel): {d_ms:.3f} ms = "
            f"{KG_T / d_ms * 1e3:.0f} steps/s")
        say(f"   {name}: {ops} operations per step; {nbytes / 1e6:.3f} MB; "
            f"bound {b_ms:.4f} ms by {b_by}; the "
            + (f"cluster barriers' floor {c_floor:.4f} ms" if ek1d else
               f"grid barriers' floor {floor_ms:.4f} ms"))
        del case
    return ms, p_ms, err, bounds


def kron_phases(odt, card, built):
    """Phases 37-39. Returns (launches on the main path's runs, ms, plain
    ms, max |kernel - plain|, bounds) of the two Kron-grid kernels."""
    say(f"== 37. the Kron-grid kernels vs plain, N={KG_N_CHECK} "
        f"({KG_N_CHECK ** 2} points), T={KG_T_CHECK}, dt={KG_DT_CHECK:g}, "
        "float64 and float32, bit for bit; DiagonalEK1 also at N in "
        f"{KG_N_BIG + (KG_N_COOP,)}, T={KG_T_BIG}")
    big = {}
    for dtype in (torch.float64, torch.float32):
        for ek1d in (False, True):
            kron_vs_plain(str(dtype)[6:],
                          KronGrid(ek1d, KG_N_CHECK, KG_T_CHECK, KG_SE_CHECK,
                                   dtype, KG_DT_CHECK))
        for N in KG_N_BIG + (KG_N_COOP,):
            case = KronGrid(True, N, KG_T_BIG, KG_SE_CHECK, dtype,
                            KG_DT_CHECK)
            want = "cooperative" if N == KG_N_COOP else "cluster"
            route = kron_route(case)
            check(route == want,
                  f"N={N} ({N * N} points): DiagonalEK1's launch runs its "
                  f"{route} kernel, expected the {want} one")
            kron_vs_plain(f"{str(dtype)[6:]} N={N} ({N * N} points)", case)
            if dtype == torch.float32:
                big[N] = time_ms(case.kernel, warmup=3, iters=20)
            del case
    say(f"   f32 ek1d_kron_grid kernel over {KG_T_BIG} steps: "
        + ", ".join(f"N={N} ({'cooperative' if N == KG_N_COOP else 'cluster'}"
                    f") {t:.4f} ms" for N, t in big.items())
        + f" (card: {card})")
    say(f"== 38. the Kron-grid paths: solve_brusselator_ek0 / _ek1d, "
        f"N={KG_N} (d = {2 * KG_N ** 2}), tspan={KG_TSPAN}, T={KG_T}, "
        f"save_every={KG_SE}, float32 and float64")
    launches = kron_path(odt)
    say(f"== 39. the Kron-grid kernels vs plain and timing, float32, "
        f"N={KG_N}, T={KG_T}")
    ms, p_ms, err, bounds = kron_timing(odt, card)
    print_registers(built["log"], KG_NAMES + ("ek1d_kron_cluster",),
                    only="_kernelIf")
    return launches, ms, p_ms, err, bounds


# -- the time-parallel solves (phases 40-43) --------------------------------

TP_NAMES = ("tp_chunk_scan", "tp_totals_scan", "tp_fixup")
# the group kernels of tp_group.cuh (all three at D != 8, the totals scan
# at every D)
TP_GROUP_NAMES = ("tp_chunk_scan_group", "tp_totals_scan_group",
                  "tp_fixup_group")
# and those of tp_wide.cuh (all three above D = 32, a CTA per combine)
TP_WIDE_NAMES = ("tp_chunk_scan_wide", "tp_totals_scan_wide", "tp_fixup_wide")
# the JAX package's time-parallel record (benchmarks/tp_accuracy_experiment.py,
# time_parallel_sweep.py): FitzHugh-Nagumo over (0, 20), N = 16384 uniform
# steps, q = 3 (D = 8), 2 sweeps; EK1 global, EK0 in 16 windows of 1024
TP_N, TP_TSPAN, TP_ITERS, TP_WINDOWS = 16384, (0.0, 20.0), 2, 16
# phase 40: elements at these lengths (3000: identity padding, 3 rows)
TP_CHECK_NS = (3000, 16384)
# float64 means against DOP853 (rtol = atol = 1e-12) and against the port's
# sequential fixed-grid smoother (fixed diffusion, one member) on the same
# grid, by path (global EK1, windowed EK0). CPU plain path, these defaults
# (warm start, the fused scans' plain versions): the global EK1 solve
# misses DOP853 by 3.21e-11 and the sequential EK1 smoother by 1.41e-13;
# the windowed EK0 solve misses both by 5.17e-5, its 2 sweeps a window
# short of the fixed point (the JAX sweep's speed configuration; its own
# float32 record there is 1.61e-4, benchmarks/time_parallel_sweep.json), and
# its sigma^2 is that of the unconverged linearization's innovations
# (2.6e4 against the sequential smoother's 8.9e-4), reported, not held.
TP_DOP853_LIMIT = {True: 1e-9, False: 1e-4}
TP_SEQ_LIMIT = {True: 1e-9, False: 1e-4}
# float32 against float64 means at the worst grid point (the JAX record for
# its float32 parallel solve: 1.07e-4 against the float64 sequential one,
# benchmarks/tp_accuracy.json)
TP_F32_LIMIT = 1e-3
# float32 against float64 stds, absolute, at every grid point. At N = 16384
# no float32 std has a correct digit: the float32 innovations sit at their
# rounding floor, ~1e3-1e7 x the float64 ones against S = H P H^T, so the
# float32 sigma^2 (4.6e3 on the CPU plain path against 8.9e-4) and with it
# the stds (1.0e-8 against 4.5e-12) are the floor's. What is held is that
# every float32 std stays below the float32 spacing of the means (|u| <=
# 2.1: 2.4e-7): CPU plain path, max |std32 - std64| 1.0e-8 (global EK1),
# 2.5e-8 (windowed EK0).
TP_F32_STD_LIMIT = 1e-7
# the float32 floor's witness: the global EK1 door (fused scans) at fewer
# steps, float32 sigma^2 over float64's; at N = 512 the innovations are
# above the floor and the two agree (CPU plain path: 1.0076 at 512, 1.48 at
# 1024, 38 at 2048, 1.9e3 at 4096, 5.2e6 at 16384)
TP_S2_NS, TP_S2_RTOL = (512, 2048), 0.05
# phase 40 at other state dimensions: FitzHugh-Nagumo (d = 2) with
# EK1(order=q), D = 2 (q + 1): (D, q); elements of the first N steps
TP_DIMS, TP_DIM_NS = ((6, 2), (12, 5)), (1024, 3000)
# and the smaller group sizes at N = 1024 alone: G = 4 by FitzHugh-Nagumo
# with EK1(order=1) (D = 4), G = 2 and 4 by synthetic conditioned elements
# at D = 2 and 3 (no model of the library has d = 1 or 3)
TP_SMALL_DIMS, TP_SYNTH_DIMS, TP_SMALL_N = ((4, 1),), (2, 3), 1024
# and group size 32 (17 <= D <= 32; Lorenz-63 at q = 5 is D = 18) by
# synthetic conditioned elements at D = 18 and 32, N = 2048 (two chunk
# rows, so that the chunk scan combines too); timed in phase 43 at N =
# 16384 (the plain combines at D = 32 take ~1 s each on the card)
TP_WIDE_DIMS, TP_WIDE_N = (18, 32), 2048
# and above 32, a CTA per combine (ops/csrc/tp_wide.cuh), by synthetic
# conditioned elements at N = 1025 (two chunk rows): D = 40 (the workspace
# in shared memory in both dtypes), 64 (shared in float32, global in
# float64) and 96 (global in both), the plain totals scan's ten rounds
# replayed from a CUDA graph (the plain combines at D = 96 take ~3 s a
# round of host-side launches); timed in phase 43 at N = 2048
TP_CTA_DIMS, TP_CTA_N, TP_CTA_TIME_N = (40, 64, 96), 1025, 2048
# phase 46: the card's default door at D = 40, a d = 10 torch field
# (tp_chain: a damped chain of oscillators, linear, so that EK1's
# linearization is exact) at q = 3 over (0, 5) on N = 2048 steps, without
# the warm start (no CUDA field of d >= 9 exists for its adaptive kernel),
# 2 sweeps: float64 means within TP40_BLOCKED of the same solve on the
# XLA-form scan on the card (the plain associative scan, block=0: the
# blocked scan at auto_block(N) took 58 s there, its chunks' sequential
# combines launch-bound), the stds and the state covariances within
# TP40_STD_RTOL of their largest value (the fused
# combines floor their Gram-Schmidt pivots at sqrt(1e-30), as the JAX
# kernels do: on the solver's rank-deficient factors the covariances differ
# from the XLA-form scans' by more than rounding; the stds of a 2-sweep
# solve by up to 2.8e-4 relative at D = 8, tests/test_torch_time_parallel.py;
# here, against the plain associative scan (block=0): means 2.83e-13, stds
# 5.93e-4 and covariances 3.98e-4 of their largest value on the card (H100,
# float64), 3.89e-13, 7.36e-4 and 5.35e-4 on the CPU plain path; against
# DOP853 3.8e-12)
TP40_D, TP40_N, TP40_TSPAN, TP40_BLOCKED, TP40_STD_RTOL = 10, 2048, (0.0, 5.0), \
    1e-9, 1e-3
# phase 44: the card's default door at D = 6, EK1(order=2), its default
# iterations: the float64 means held within TP6_DOP853 of DOP853 at N =
# 16384, and at N = 1024 within TP6_SEQ of the sequential fixed-grid
# EK1(order=2) smoother (its plain version on the host, in a process of its
# own beside phases 40-43: ~20 s at 1024 steps, ~330 s at 16384). CPU plain
# path (these defaults, block='fused'): 3.27e-11 from DOP853; 3.60e-10 from
# the sequential smoother (4.86e-10 after 8 sweeps, with the warm start at
# order 2 or 3 alike: the iterated smoother's fixed point against the
# one-pass EK1 smoother at dt = 0.0195); float32 against float64 9.14e-5,
# stds 5.20e-9
TP6_Q, TP6_SEQ_N = 2, 1024
TP6_DOP853, TP6_SEQ = 1e-9, 5e-9


def tp_fhn(dtype):
    from odefilters_torch import models

    return models.fitzhugh_nagumo(tspan=TP_TSPAN, device=DEVICE, dtype=dtype)


def tp_problem(dtype):
    ts = torch.linspace(*TP_TSPAN, TP_N + 1, dtype=dtype, device=DEVICE)
    return tp_fhn(dtype), ts


def tp_elements(prob, alg, ts, u_lin, lo=0, hi=None, plain=True):
    """The filtering elements of steps lo..hi-1 of ``prob`` on ``ts``,
    linearized along ``u_lin`` (the grid's points after t0), from the
    solve's zero-covariance initial state; and the smoothing elements of
    the filtered states of the plain scan (``plain``) or of the kernels,
    reversed (the order the scan runs them)."""
    from odefilters_torch.ops import tp_scan as ts_
    from odefilters_torch.parallel import associative as pa
    from odefilters_torch.parallel import associative_sqrt as asq

    c = pa._setup(prob, alg, ts)
    hi = c.N if hi is None else hi
    H, y = c.build_elements(u_lin[lo:hi], ts[1 + lo:1 + hi])
    U0 = torch.zeros((c.D, c.D), dtype=c.dtype, device=DEVICE)
    fe = asq.filter_elements(c.m0, U0, c.A, c.QL, H, y)
    scan = tp_plain_scan if plain else ts_.fused_associative_scan
    _, ms, Us, _, _ = scan("filter", fe)
    se = asq.smoother_elements(torch.cat([c.m0[None], ms]),
                               torch.cat([U0[None], Us]), c.A, c.QL)
    return fe, tuple(torch.flip(e, (0,)) for e in se)


def tp_synth_elements(kind, n, D, dtype, seed):
    """n conditioned elements of state dimension D (as the CPU tests'):
    transitions 0.5 I plus noise of spectral radius ~0.3, factors and vectors
    of that scale, from numpy with ``seed``."""
    rng = np.random.default_rng(seed)
    scale = 0.3 * (2.0 / D) ** 0.5

    def mk(*shape):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype,
                            device=DEVICE)

    eye = torch.eye(D, dtype=dtype, device=DEVICE)
    if kind == "filter":
        return (mk(n, D, D) + 0.5 * eye, mk(n, D), mk(n, D, D), mk(n, D),
                mk(n, D, D))
    return (mk(n, D, D) + 0.5 * eye, mk(n, D), mk(n, D, D))


def tp_plain_scan(kind, elems):
    """The three plain phases on ``elems``, unpacked."""
    from odefilters_torch.ops import tp_scan as ts_

    packed = ts_.pack(kind, elems)
    pre = ts_.chunk_scan_plain(kind, packed)
    out = ts_.fixup_plain(kind, pre, ts_.totals_scan_plain(kind, pre))
    return ts_.unpack(kind, out, elems[0].shape[0])


class ReplayedCombine:
    """A plain combine captured once in a CUDA graph on its first call and
    replayed on every later one (inputs copied into the captured ones): the
    same kernels on the same values in the same order, so the same bits,
    without the host-side launches, which at D > 32 take seconds a call."""

    def __init__(self, combine):
        self.combine, self.graph = combine, None

    def __call__(self, ea, eb):
        if self.graph is None:
            self.ea = tuple(x.clone() for x in ea)
            self.eb = tuple(x.clone() for x in eb)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.combine(self.ea, self.eb)  # warm-up, as capture asks
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.combine(self.ea, self.eb)
        for dst, src in zip(self.ea + self.eb, tuple(ea) + tuple(eb)):
            dst.copy_(src)
        self.graph.replay()
        return self.out


def tp_totals_plain_replayed(kind, prefixes):
    """`tp_scan.totals_scan_plain` with its combine a `ReplayedCombine`:
    nine of its ten rounds replayed."""
    from odefilters_torch.ops import tp_scan as ts_

    plain = ts_._COMBINES[kind]
    ts_._COMBINES[kind] = ReplayedCombine(plain)
    try:
        return ts_.totals_scan_plain(kind, prefixes)
    finally:
        ts_._COMBINES[kind] = plain


def tp_vs_plain(label, kind, elems, strict=True, replay=False):
    """Each of the three kernels against its plain version on the same
    inputs (the chunk scan on the packed elements, the totals scan and the
    fixup on the plain version's prefixes and totals), bit for bit, and the
    fused scan through `fused_associative_scan` against the plain phases,
    one launch of each kernel (``replay``: the plain totals scan's combine
    replayed from a CUDA graph, `tp_totals_plain_replayed`). Returns (max
    |kernel - plain|, plain milliseconds of each phase)."""
    from odefilters_torch.ops import tp_scan as ts_

    packed = ts_.pack(kind, elems)
    pre, p_pre = once(lambda: ts_.chunk_scan_plain(kind, packed))
    totals = tp_totals_plain_replayed if replay else ts_.totals_scan_plain
    tex, p_tex = once(lambda: totals(kind, pre))
    out, p_fix = once(lambda: ts_.fixup_plain(kind, pre, tex))
    got = (ts_.tp_chunk_scan(kind, packed), ts_.tp_totals_scan(kind, pre),
           ts_.tp_fixup(kind, pre, tex))
    err = 0.0
    for name, g, r in zip(TP_NAMES, got, (pre, tex, out)):
        check(bool(torch.isfinite(g).all()), f"{label} {name}_kernel: finite")
        bitwise(f"{label} {name}_kernel", g, r, strict=strict)
        err = max(err, float((g.double() - r.double()).abs().max()))
    reset_counts()
    full = ts_.fused_associative_scan(kind, elems)
    torch.cuda.synchronize()
    n = read_counts(*TP_NAMES)
    check(all(v == 1 for v in n.values()),
          f"{label} fused_associative_scan: launches {n}, one each")
    for i, (a, r) in enumerate(zip(full, ts_.unpack(kind, out,
                                                    elems[0].shape[0]))):
        bitwise(f"{label} fused_associative_scan, leaf {i}", a, r,
                strict=strict)
    return err, {"tp_chunk_scan": p_pre, "tp_totals_scan": p_tex,
                 "tp_fixup": p_fix}


def tp_blocked_diff(fused, blocked, kind):
    """The largest difference of the fused and the blocked scans' outputs
    per leaf, factors compared as ``U U^T``, each over its leaf's largest
    |value| (reported: the fused combines' Gram-Schmidt floors its pivots
    at sqrt(1e-30), as the JAX kernels do, and the solver's factors are
    rank-deficient, so the two scans' covariances differ by more than
    rounding; JAX's list combine misses its XLA combine by 1.2e-5 on the
    first two elements of these scans in float64)."""
    out = []
    for i, (g, r) in enumerate(zip(fused, blocked)):
        if i in ((2, 4) if kind == "filter" else (2,)):
            g, r = g @ g.transpose(-1, -2), r @ r.transpose(-1, -2)
        scale = float(r.abs().max())
        out.append(float((g - r).abs().max()) / (scale or 1.0))
    return ", ".join(f"{x:.2e}" for x in out)


def tp_reference(prob, ts):
    """FitzHugh-Nagumo by DOP853 (rtol = atol = 1e-12) on ``ts``."""
    return torch.tensor(reference_solution(
        prob.u0.cpu().double().numpy(), prob.p.cpu().double().numpy(),
        ts.cpu().double().numpy()))


def tp_door(odt, prob, ts, ek1):
    alg = odt.EK1(order=Q) if ek1 else odt.EK0(order=Q)
    kw = {} if ek1 else {"windows": TP_WINDOWS}
    return alg, lambda: odt.solve_fixed_parallel(prob, alg, ts=ts,
                                                 iterations=TP_ITERS, **kw)


def tp_sigma2_floor(odt):
    """The float32 sigma^2 against float64's in the global EK1 door (fused
    scans, warm start) at fewer steps: held within TP_S2_RTOL at the
    first N, reported at the others."""
    for i, N in enumerate(TP_S2_NS):
        s2 = {}
        for dtype in (torch.float64, torch.float32):
            prob = tp_fhn(dtype)
            ts = torch.linspace(*TP_TSPAN, N + 1, dtype=dtype, device=DEVICE)
            s2[dtype] = float(odt.solve_fixed_parallel(
                prob, odt.EK1(order=Q), ts=ts, iterations=TP_ITERS,
                block="fused")[4])
        r = s2[torch.float32] / s2[torch.float64]
        msg = (f"f32 vs f64 global EK1 at N={N}: sigma2 "
               f"{s2[torch.float32]:.6e} vs {s2[torch.float64]:.6e}, ratio "
               f"{r:.4f}")
        if i == 0:
            check(abs(r - 1) <= TP_S2_RTOL, f"{msg}, within {TP_S2_RTOL:g} "
                  "(above the float32 floor)")
        else:
            say(f"   {msg} (reported)")


def tp_path(odt, ek1):
    """Phases 41 and 42: the global EK1 (``ek1``) or the windowed EK0 solve
    at N = 16384, float64 and float32, each run with the counts set to 0
    before it and read after it. Returns the float32 run's launches and its
    outputs."""
    from odefilters_torch.parallel import associative as pa

    what = "global EK1" if ek1 else f"windowed EK0 ({TP_WINDOWS} windows)"
    scans = 4 if ek1 else 4 * TP_WINDOWS
    outs, launches = {}, None
    for dtype in (torch.float64, torch.float32):
        label = f"{str(dtype)[6:]} {what}"
        prob, ts = tp_problem(dtype)
        alg, door = tp_door(odt, prob, ts, ek1)
        block, ws = pa.resolve_options(prob, alg, TP_N, windows=None if ek1
                                       else TP_WINDOWS)
        check(block == "fused" and ws == 8,
              f"{label}: the defaults resolve to block={block!r}, "
              f"warm_start={ws} (expected 'fused', 8)")
        reset_counts()
        out, d_ms = once(door)
        n = read_counts(*TP_NAMES, "ek0_adaptive")
        say(f"   {label}: launches {n} ({d_ms:.1f} ms, the first call)")
        check(all(n[k] == scans for k in TP_NAMES) and n["ek0_adaptive"] == 1,
              f"{label}: {scans} launches of each scan kernel "
              f"({scans // 2} filter and {scans // 2} smoother scans) and 1 "
              "of ek0_adaptive (the warm start)")
        u, u_std, means, covs, sigma2 = out
        check(tuple(u.shape) == (TP_N + 1, 2) and tuple(covs.shape)
              == (TP_N + 1, 8, 8) and u_std.shape == u.shape,
              f"{label}: shapes u {tuple(u.shape)}, covs {tuple(covs.shape)}")
        check(bool(torch.isfinite(u).all() and torch.isfinite(u_std).all()
                   and torch.isfinite(sigma2)),
              f"{label}: finite u, u_std and sigma2 ({float(sigma2):.6e})")
        outs[dtype] = out
        if dtype == torch.float32:
            launches = {k: n[k] for k in TP_NAMES}
    prob64, ts64 = tp_problem(torch.float64)
    u64 = outs[torch.float64][0]
    ref = tp_reference(prob64, ts64)
    e_ref = float((u64.cpu() - ref).abs().max())
    check(e_ref <= TP_DOP853_LIMIT[ek1], f"f64 {what} vs DOP853: max |du| "
          f"{e_ref:.3e} <= {TP_DOP853_LIMIT[ek1]:g}")
    alg_seq = (odt.EK1(order=Q, diffusionmodel="fixed") if ek1
               else odt.EK0(order=Q, diffusionmodel="fixed"))
    seq = odt.solve_ensemble(prob64, alg_seq, prob64.u0[None].clone(),
                             prob64.p[None].clone(), n_save=TP_N,
                             adaptive=False)
    e_seq = float((u64 - seq.us[..., 0]).abs().max())
    check(e_seq <= TP_SEQ_LIMIT[ek1], f"f64 {what} vs the sequential "
          f"fixed-grid smoother ({alg_seq.__class__.__name__}, fixed "
          f"diffusion): max |du| {e_seq:.3e} <= {TP_SEQ_LIMIT[ek1]:g}; sigma2 "
          f"{float(outs[torch.float64][4]):.6e} vs {float(seq.diffusions[0]):.6e}")
    du = (outs[torch.float32][0].double() - u64).abs()
    k = int(du.amax(dim=1).argmax())
    check(float(du.max()) <= TP_F32_LIMIT,
          f"f32 vs f64 {what}: max |du| {float(du.max()):.3e} at grid point "
          f"{k} <= {TP_F32_LIMIT:g}")
    s64, s32 = outs[torch.float64][1], outs[torch.float32][1].double()
    dsd = float((s32 - s64).abs().max())
    check(dsd <= TP_F32_STD_LIMIT,
          f"f32 vs f64 {what}: max |du_std| {dsd:.3e} <= {TP_F32_STD_LIMIT:g} "
          f"(largest std f32 {float(s32.max()):.3e}, f64 "
          f"{float(s64.max()):.3e}); sigma2 f32 "
          f"{float(outs[torch.float32][4]):.6e}, f64 "
          f"{float(outs[torch.float64][4]):.6e} (reported)")
    if ek1:
        tp_sigma2_floor(odt)
    # the scans of the solve's next sweep: its elements linearized at its
    # own output (one window's for the windowed solve), the kernels bit for
    # bit against the plain scans
    hi = TP_N if ek1 else TP_N // TP_WINDOWS
    for dtype in (torch.float64, torch.float32):
        prob, ts = tp_problem(dtype)
        alg, _ = tp_door(odt, prob, ts, ek1)
        fe, se = tp_elements(prob, alg, ts, outs[dtype][0][1:], 0, hi)
        for kind, el in (("filter", fe), ("smooth", se)):
            tp_vs_plain(f"{str(dtype)[6:]} {what}, the solve's {kind} "
                        f"elements (N = {hi})", kind, el)
    return launches, outs


def tp_seq_host(n_steps):
    """The sequential fixed-grid EK1(order=TP6_Q) smoother (fixed
    diffusion) of the time-parallel record's FitzHugh-Nagumo on n_steps
    uniform steps, its plain version on the host: (means (n_steps + 1, 2),
    sigma^2, seconds), as numpy. Run in a process of its own while the
    card's phases run (the fused EK1 kernels are built for q = 3 only)."""
    import odefilters_torch as odt
    from odefilters_torch import models

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    host = models.fitzhugh_nagumo(tspan=TP_TSPAN, device="cpu")
    sol = odt.solve_ensemble(
        host, odt.EK1(order=TP6_Q, diffusionmodel="fixed"),
        host.u0[None].clone(), host.p[None].clone(), n_save=n_steps,
        adaptive=False)
    return (sol.us[..., 0].numpy(), float(sol.diffusions[0]),
            time.perf_counter() - t0)


def tp_dim_door(odt, seq):
    """Phase 44: the card's default ``solve_fixed_parallel(prob,
    EK1(order=2))`` (D = 6) at N = 16384 in float64 and float32, each run
    with the counts set to 0 before it and read after it: the defaults
    resolve to the fused scan and the warm start, 2 launches of each scan
    kernel a sweep and 1 of ``ek0_adaptive`` at order 2 (min(q, 3), as in
    the JAX package); shapes, finite values; float64
    against DOP853, float32 against float64; then the float64 door at N =
    TP6_SEQ_N against the sequential fixed-grid EK1(order=2) smoother (its
    plain version on the host, ``seq``: a future of `tp_seq_host`).
    Returns the float32 run's launches."""
    import inspect

    from odefilters_torch.ops import ek0_adaptive as ea
    from odefilters_torch.parallel import associative as pa

    alg = odt.EK1(order=TP6_Q)
    D = 2 * (TP6_Q + 1)
    iters = inspect.signature(odt.solve_fixed_parallel).parameters[
        "iterations"].default
    scans = 2 * iters
    outs, launches = {}, None

    def door(dtype, N):
        prob = tp_fhn(dtype)
        ts = torch.linspace(*TP_TSPAN, N + 1, dtype=dtype, device=DEVICE)
        label = f"{str(dtype)[6:]} EK1(order={TP6_Q}) at N={N}"
        block, ws = pa.resolve_options(prob, alg, N)
        check(block == "fused" and ws == 8,
              f"{label}: the defaults resolve to block={block!r}, "
              f"warm_start={ws} (expected 'fused', 8)")
        reset_counts()
        by_order = dict(ea.ek0_adaptive.launches_by_order)
        out, d_ms = once(lambda: odt.solve_fixed_parallel(prob, alg, ts=ts))
        n = read_counts(*TP_NAMES, "ek0_adaptive")
        warm = {q: ea.ek0_adaptive.launches_by_order[q] - by_order[q]
                for q in by_order}
        check(all(n[k] == scans for k in TP_NAMES) and n["ek0_adaptive"] == 1
              and warm[TP6_Q] == 1,
              f"{label}: launches {n} ({d_ms:.1f} ms, the first call): "
              f"{scans} of each scan kernel ({iters} sweeps) and 1 of "
              f"ek0_adaptive (the warm start), at order {TP6_Q} as in the JAX "
              f"package (by order: {warm})")
        u, u_std, means, covs, sigma2 = out
        check(tuple(u.shape) == (N + 1, 2) and u_std.shape == u.shape
              and tuple(covs.shape) == (N + 1, D, D)
              and bool(torch.isfinite(u).all() and torch.isfinite(u_std).all()
                       and torch.isfinite(sigma2)),
              f"{label}: shapes u {tuple(u.shape)}, covs {tuple(covs.shape)}; "
              f"finite u, u_std and sigma2 ({float(sigma2):.6e})")
        return out, n

    for dtype in (torch.float64, torch.float32):
        outs[dtype], n = door(dtype, TP_N)
        if dtype == torch.float32:
            launches = {k: n[k] for k in TP_NAMES}
    prob64, ts64 = tp_problem(torch.float64)
    u64 = outs[torch.float64][0]
    e_ref = float((u64.cpu() - tp_reference(prob64, ts64)).abs().max())
    check(e_ref <= TP6_DOP853, f"f64 EK1(order={TP6_Q}) at N={TP_N} vs DOP853: "
          f"max |du| {e_ref:.3e} <= {TP6_DOP853:g}")
    du = float((outs[torch.float32][0].double() - u64).abs().max())
    dsd = float((outs[torch.float32][1].double() - outs[torch.float64][1])
                .abs().max())
    check(du <= TP_F32_LIMIT and dsd <= TP_F32_STD_LIMIT,
          f"f32 vs f64 EK1(order={TP6_Q}) at N={TP_N}: max |du| {du:.3e} <= "
          f"{TP_F32_LIMIT:g}, max |du_std| {dsd:.3e} <= {TP_F32_STD_LIMIT:g}; "
          f"sigma2 f32 {float(outs[torch.float32][4]):.6e}, f64 "
          f"{float(outs[torch.float64][4]):.6e} (reported)")
    del outs
    (u, *_, s2), _ = door(torch.float64, TP6_SEQ_N)
    u_seq, s2_seq, seq_s = seq.result()
    e_seq = float((u.cpu() - torch.from_numpy(u_seq)).abs().max())
    check(e_seq <= TP6_SEQ, f"f64 EK1(order={TP6_Q}) at N={TP6_SEQ_N} vs the "
          f"sequential fixed-grid smoother (plain, on the host, {seq_s:.1f} s "
          f"beside phases 40-43): max |du| {e_seq:.3e} <= {TP6_SEQ:g}; "
          f"sigma2 {float(s2):.6e} vs {s2_seq:.6e}")
    return launches


def tp_chain(u, p, t):
    """Phase 46's d = TP40_D field: a periodic chain of oscillators, each
    coupled to its two neighbours and damped, du_i/dt = -0.1 u_i + u_{i-1}
    - u_{i+1} (a torch field: no CUDA stencil, its Jacobian by forward-mode
    JVPs)."""
    return -0.1 * u + torch.roll(u, 1, 0) - torch.roll(u, -1, 0)


def tp_cta_door(odt):
    """Phase 46: ``solve_fixed_parallel(EK1(order=3), warm_start=0)`` on
    tp_chain (D = 40) at N = TP40_N in float64 and float32, each run with
    the counts set to 0 before it and read after it: the defaults resolve
    to the fused scan, whose kernels run a CTA per combine (2 launches of
    each a sweep); shapes, finite values; float64 against the same solve
    on the XLA-form scan (its combines: the plain associative scan,
    block=0) on the card and against DOP853; float32 against float64.
    Returns the float32 run's launches."""
    from scipy.integrate import solve_ivp

    from odefilters_torch.parallel import associative as pa

    alg = odt.EK1(order=Q)
    D = TP40_D * (Q + 1)
    u0 = np.sin(np.arange(TP40_D) + 1.0)
    outs, launches = {}, None
    for dtype in (torch.float64, torch.float32):
        prob = odt.ode_problem(tp_chain, u0, TP40_TSPAN, device=DEVICE,
                               dtype=dtype)
        ts = torch.linspace(*TP40_TSPAN, TP40_N + 1, dtype=dtype,
                            device=DEVICE)
        label = f"{str(dtype)[6:]} EK1(order={Q}) at D={D}, N={TP40_N}"
        block, ws = pa.resolve_options(prob, alg, TP40_N, warm_start=0)
        check(block == "fused" and ws == 0,
              f"{label}: the defaults resolve to block={block!r}, "
              f"warm_start={ws} (expected 'fused', 0)")
        reset_counts()
        out, d_ms = once(lambda: odt.solve_fixed_parallel(
            prob, alg, ts=ts, warm_start=0, iterations=TP_ITERS))
        n = read_counts(*TP_NAMES)
        check(all(n[k] == 2 * TP_ITERS for k in TP_NAMES),
              f"{label}: launches {n} ({d_ms:.1f} ms, the first call), "
              f"{2 * TP_ITERS} of each scan kernel ({TP_ITERS} sweeps)")
        u, u_std, means, covs, sigma2 = out
        check(tuple(u.shape) == (TP40_N + 1, TP40_D) and u_std.shape == u.shape
              and tuple(covs.shape) == (TP40_N + 1, D, D)
              and bool(torch.isfinite(u).all() and torch.isfinite(u_std).all()
                       and torch.isfinite(sigma2)),
              f"{label}: shapes u {tuple(u.shape)}, covs {tuple(covs.shape)}; "
              f"finite u, u_std and sigma2 ({float(sigma2):.6e})")
        outs[dtype] = out
        if dtype == torch.float32:
            launches = n
    prob = odt.ode_problem(tp_chain, u0, TP40_TSPAN, device=DEVICE)
    ts = torch.linspace(*TP40_TSPAN, TP40_N + 1, dtype=torch.float64,
                        device=DEVICE)
    ref, b_ms = once(lambda: odt.solve_fixed_parallel(
        prob, alg, ts=ts, warm_start=0, iterations=TP_ITERS, block=0))
    u, u_std, _, covs = outs[torch.float64][:4]
    du = float((u - ref[0]).abs().max())
    dsd = float((u_std - ref[1]).abs().max() / ref[1].abs().max())
    dcov = float((covs - ref[3]).abs().max() / ref[3].abs().max())
    check(du <= TP40_BLOCKED and dsd <= TP40_STD_RTOL
          and dcov <= TP40_STD_RTOL,
          f"f64 D={D}: fused scan vs the plain associative scan (the XLA-form "
          f"combines, block=0) on the card ({b_ms:.1f} ms): max |du| "
          f"{du:.3e} <= {TP40_BLOCKED:g}; "
          f"max |du_std| {dsd:.3e} and max |dcov| {dcov:.3e} of their "
          f"largest <= {TP40_STD_RTOL:g}; sigma2 "
          f"{float(outs[torch.float64][4]):.9e} vs {float(ref[4]):.9e}")
    tsn = ts.cpu().numpy()
    dop = solve_ivp(lambda t, y: -0.1 * y + np.roll(y, 1) - np.roll(y, -1),
                    TP40_TSPAN, u0, method="DOP853", t_eval=tsn, rtol=1e-12,
                    atol=1e-12)
    e_ref = float(np.abs(u.cpu().numpy() - dop.y.T).max())
    du32 = float((outs[torch.float32][0].double() - u).abs().max())
    check(du32 <= TP_F32_LIMIT,
          f"f32 vs f64 at D={D}: max |du| {du32:.3e} <= {TP_F32_LIMIT:g}; f64 "
          f"vs DOP853 {e_ref:.3e} (reported)")
    return launches


def tp_combine_ops(kind, D):
    """Floating-point operations of one combine as the CUDA body runs it
    (``tp_scan.cuh``: filter_combine, smooth_combine): each add, subtract,
    multiply, divide, square root and pivot floor once, the terms through
    the identity blocks' structural zeros skipped, as the kernel skips
    them."""
    mm = D * D * (2 * D - 1)      # D^2 entries: D products, D - 1 sums
    mv = D * (2 * D - 1)
    fwd_rows = D ** 3             # D rows of sum_i (2 i + 1)
    cho = 2 * D * D               # forward and back substitution

    def mgs(tri):                 # ek0::mgs_tril of a 2D x D stack
        n = 0
        for j in range(D):
            live = 2 * D - (D - 1 - j if tri else 0)
            # the sum of squares, floor, sqrt, reciprocal, the scaled
            # column, then a dot product and an update per later column
            n += 2 * live + 3 + live + (D - 1 - j) * 4 * live
        return n

    if kind == "filter":
        # 7 products, 9 matrix-vector products, 2 row substitutions, the
        # Cholesky solve of D columns and of one vector, I - M and 5 vector
        # sums, chol(I + W W^T), chol(I + W^T W), 2 re-triangularizations
        return (7 * mm + 9 * mv + 2 * fwd_rows + (D + 1) * cho + D * D
                + 5 * D + 2 * mgs(True) + 2 * mgs(False))
    return 2 * mm + mv + D + mgs(False)


# the scan kernels of a door at D = 8, as torch.profiler names them: the
# one-thread chunk scan and fixup, the group totals scan
TP_PROFILED = ("tp_chunk_scan_kernel", "tp_totals_scan_group_kernel",
               "tp_fixup_kernel")


def tp_door_profile(door):
    """One call of ``door`` under ``torch.profiler``: for each kernel of
    TP_PROFILED, the card's time in it summed over its launches as the
    profiler records them, and their number. The times are None where the
    profiler records no device time at all."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        door()
        torch.cuda.synchronize()
    total_us = 0.0
    kernel_us = {k: 0.0 for k in TP_PROFILED}
    n = {k: 0 for k in TP_PROFILED}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        total_us += t
        for k in TP_PROFILED:
            if k in ev.key and t > 0:
                kernel_us[k] += t
                n[k] += ev.count
    return {k: ((kernel_us[k] / 1e3 if total_us > 0 else None), n[k])
            for k in TP_PROFILED}


TP_WINDOW_N = TP_N // TP_WINDOWS  # the windowed door's scans: one chunk row


def tp_timing(odt, card):
    """Phase 43: float32 at N = 16384. Each kernel per kind (median of 20
    after 3 warm-ups, CUDA events) beside its plain version (once) and its
    bound; the totals scan also at the windowed door's N = 1024 (bit for bit
    against its plain version there); the group kernels at the other
    state dimensions of phase 40; the fused scan against the blocked scan at
    auto_block(N) (one call); the doors and their parts, and the windowed
    door's 64 totals scans' summed kernel time (torch.profiler). Returns
    (ms, plain ms, max |kernel - plain|, bounds) of the filter kind, the
    main path's larger."""
    from odefilters_torch.ops import tp_scan as ts_
    from odefilters_torch.parallel import associative as pa
    from odefilters_torch.parallel import associative_sqrt as asq
    from odefilters_torch.parallel.blocked import (
        auto_block, blocked_associative_scan)
    from odefilters_torch.taylor import taylor_coefficients

    prob, ts = tp_problem(torch.float32)
    alg, door = tp_door(odt, prob, ts, True)
    u_lin = door()[0][1:]
    fe, se = tp_elements(prob, alg, ts, u_lin)
    item = 4
    ms, p_ms, err, bounds = {}, {}, {}, {}
    for kind, el in (("filter", fe), ("smooth", se)):
        e, pm = tp_vs_plain(f"f32 {kind} at N={TP_N}", kind, el)
        packed = ts_.pack(kind, el)
        L, V, _ = packed.shape
        pre = ts_.tp_chunk_scan(kind, packed)
        tex = ts_.tp_totals_scan(kind, pre)
        k_ms = {
            "tp_chunk_scan": time_ms(lambda: ts_.tp_chunk_scan(kind, packed),
                                     warmup=3, iters=20),
            "tp_totals_scan": time_ms(lambda: ts_.tp_totals_scan(kind, pre),
                                      warmup=3, iters=20),
            "tp_fixup": time_ms(lambda: ts_.tp_fixup(kind, pre, tex),
                                warmup=3, iters=20),
        }
        ops = tp_combine_ops(kind, 8)
        # the least combines each phase's function needs: an inclusive scan
        # of n elements needs n - 1 (the kernel's Hillis-Steele rounds run
        # sum_r (1024 - 2^r) = 9217 for the 1023 of the totals)
        combines = {"tp_chunk_scan": (L - 1) * ts_.NC,
                    "tp_totals_scan": ts_.NC - 1,
                    "tp_fixup": L * (ts_.NC - 1)}
        moved = {"tp_chunk_scan": 2 * L * V * ts_.NC,
                 "tp_totals_scan": 2 * V * ts_.NC,
                 "tp_fixup": (2 * L + 1) * V * ts_.NC}
        for name in TP_NAMES:
            b = bound(moved[name] * item, ops * combines[name], 1, 1)
            say(f"   {kind} {name}_kernel {k_ms[name]:.4f} ms, plain (once) "
                f"{pm[name]:.1f} ms; {combines[name]} combines of {ops} "
                f"operations, {moved[name] * item / 1e6:.2f} MB: bound "
                f"{b[0]:.4f} ms by {b[1]} (card: {card})")
            if kind == "filter":
                ms[name], p_ms[name], err[name] = k_ms[name], pm[name], e
                bounds[name] = b + (ops,)
        fused_ms = time_ms(lambda: ts_.fused_associative_scan(kind, el),
                           warmup=3, iters=20)
        combine = (asq._sqrt_filter_combine if kind == "filter"
                   else asq._sqrt_smooth_combine)
        blk = auto_block(TP_N)
        blocked_ms = time_ms(lambda: blocked_associative_scan(combine, el, blk),
                             warmup=0, iters=1)
        diff = tp_blocked_diff(ts_.fused_associative_scan(kind, el),
                               blocked_associative_scan(combine, el, blk),
                               kind)
        say(f"   {kind}: fused_associative_scan {fused_ms:.3f} ms; the "
            f"blocked scan at block={blk} (one call) "
            f"{blocked_ms:.1f} ms; their largest difference per leaf, over "
            f"its scale: {diff} (reported)")
    # the global door's parts: per sweep the element build (the
    # linearization, the filter elements, then the smoother elements of the
    # filtered states) and the two scans; the Taylor init, the warm start
    # and the calibration once
    c = pa._setup(prob, alg, ts)
    U0 = torch.zeros((8, 8), device=DEVICE)
    H, y = c.build_elements(u_lin, ts[1:])
    _, ms_f, Us_f, _, _ = ts_.fused_associative_scan("filter", fe)
    parts = {
        "Taylor init": lambda: taylor_coefficients(prob.f, prob.u0, prob.p,
                                                   0.0, Q),
        "warm start (adaptive kernel, interpolation)":
            lambda: pa.warm_start_trajectory(prob, ts, 8, Q),
        "element build, one sweep": lambda: (
            asq.filter_elements(c.m0, U0, c.A, c.QL,
                                *c.build_elements(u_lin, ts[1:])),
            asq.smoother_elements(torch.cat([c.m0[None], ms_f]),
                                  torch.cat([U0[None], Us_f]), c.A, c.QL)),
        "the two fused scans, one sweep": lambda: (
            ts_.fused_associative_scan("filter", fe),
            ts_.fused_associative_scan("smooth", se)),
        "calibration": lambda: pa.global_mle(
            c, H, y, ms_f, Us_f @ Us_f.transpose(-1, -2)),
    }
    for part, fn in parts.items():
        say(f"   global EK1 door, {part}: "
            f"{time_ms(fn, warmup=3, iters=20):.3f} ms")
    # the windowed door, ~0.8 s a call: the median of 5 after 1 warm-up
    for ek1, warmup, iters in ((True, 3, 20), (False, 1, 5)):
        _, door = tp_door(odt, prob, ts, ek1)
        d_ms = time_ms(door, warmup=warmup, iters=iters)
        say(f"   solve_fixed_parallel, {'global EK1' if ek1 else 'windowed EK0'}"
            f": {d_ms:.3f} ms = {TP_N / d_ms * 1e3:.0f} steps/s (median of "
            f"{iters} after {warmup} warm-ups; card: {card})")
    # the windowed door's scans run one chunk row (N = 1024 a window): its
    # 64 totals scans, timed alone at that shape and summed in one door call
    alg0, door0 = tp_door(odt, prob, ts, False)
    u0_lin = door0()[0][1:]
    fw, sw = tp_elements(prob, alg0, ts, u0_lin, 0, TP_WINDOW_N, plain=False)
    win = {}
    for kind, el in (("filter", fw), ("smooth", sw)):
        pre = ts_.tp_chunk_scan(kind, ts_.pack(kind, el))
        label = f"f32 {kind} at N={TP_WINDOW_N} (a window)"
        bitwise(f"{label}: tp_totals_scan_kernel against its plain version",
                ts_.tp_totals_scan(kind, pre), ts_.totals_scan_plain(kind, pre),
                strict=True)
        win[kind] = time_ms(lambda: ts_.tp_totals_scan(kind, pre), warmup=3,
                            iters=20)
        say(f"   {label}: tp_totals_scan_kernel {win[kind]:.4f} ms "
            f"(card: {card})")
    est = TP_WINDOWS * TP_ITERS * sum(win.values())
    n_want = 2 * TP_WINDOWS * TP_ITERS
    prof = tp_door_profile(door0)
    for k, (prof_ms, prof_n) in prof.items():
        if prof_ms is None:
            say(f"   windowed door: torch.profiler recorded no device time; "
                f"{k}'s time in a door call is not measured")
            continue
        check(prof_n == n_want,
              f"windowed door under torch.profiler: {prof_n} launches of "
              f"{k} ({n_want} expected)")
        say(f"   windowed door, {k}: {prof_n} launches, {prof_ms:.4f} ms in "
            f"all, {prof_ms / max(prof_n, 1):.4f} ms a launch, summed in one "
            f"door call by torch.profiler (card: {card})")
    say(f"   windowed door: its {n_want} totals scans, "
        f"{TP_WINDOWS * TP_ITERS} x (filter + smoother) at the times above: "
        f"{est:.3f} ms (card: {card})")
    # the group kernels at the other state dimensions (D != 8: all three),
    # the solver's elements, and synthetic ones at group size 32
    wide = [(D, tuple(tp_synth_elements(k, N, D, torch.float32, 200 + D)
                      for k in ("filter", "smooth")))
            for D, N in [(D, TP_N) for D in TP_WIDE_DIMS]
            + [(D, TP_CTA_TIME_N) for D in TP_CTA_DIMS]]
    for D, (fd, sd) in [(D, tp_elements(prob, odt.EK1(order=q), ts, u_lin,
                                        plain=False))
                        for D, q in TP_DIMS + TP_SMALL_DIMS] + wide:
        ops_k = {"filter": tp_combine_ops("filter", D),
                 "smooth": tp_combine_ops("smooth", D)}
        for kind, el in (("filter", fd), ("smooth", sd)):
            packed = ts_.pack(kind, el)
            L, V, _ = packed.shape
            pre = ts_.tp_chunk_scan(kind, packed)
            tex = ts_.tp_totals_scan(kind, pre)
            t = {"tp_chunk_scan": lambda: ts_.tp_chunk_scan(kind, packed),
                 "tp_totals_scan": lambda: ts_.tp_totals_scan(kind, pre),
                 "tp_fixup": lambda: ts_.tp_fixup(kind, pre, tex)}
            combines = {"tp_chunk_scan": (L - 1) * ts_.NC,
                        "tp_totals_scan": ts_.NC - 1,
                        "tp_fixup": L * (ts_.NC - 1)}
            moved = {"tp_chunk_scan": 2 * L * V * ts_.NC,
                     "tp_totals_scan": 2 * V * ts_.NC,
                     "tp_fixup": (2 * L + 1) * V * ts_.NC}
            for name in TP_NAMES:
                k_ms = (time_ms(t[name], warmup=3, iters=20) if D <= 32
                        else time_ms(t[name], warmup=1, iters=3))
                b = bound(moved[name] * item, ops_k[kind] * combines[name],
                          1, 1)
                route = "group kernel" if D <= 32 else "CTA per combine"
                say(f"   D={D} N={el[0].shape[0]} {kind} {name} ({route}) "
                    f"{k_ms:.4f} ms; "
                    f"{combines[name]} combines of {ops_k[kind]} operations, "
                    f"{moved[name] * item / 1e6:.2f} MB: bound {b[0]:.4f} ms by "
                    f"{b[1]} (card: {card})")
    return ms, p_ms, err, bounds


def tp_phases(odt, card, built):
    """Phases 40-44. Returns (launches on the main path's run, ms, plain ms,
    max |kernel - plain|, bounds) of the three scan kernels. Phase 44's
    host-side reference runs in a process of its own from the start of
    phase 40, stopped before this returns."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        seq = pool.submit(tp_seq_host, TP6_SEQ_N)
        return tp_phases_on_card(odt, card, built, seq)


def tp_phases_on_card(odt, card, built, seq):
    say(f"== 40. the time-parallel scan kernels vs plain, bit for bit: "
        f"N in {TP_CHECK_NS}, float64 and float32, filter and smoother "
        "elements (EK1 linearized along DOP853's solution), forward and "
        f"reversed; and at (D, q) in {TP_DIMS}, N in {TP_DIM_NS}; at (D, q) "
        f"in {TP_SMALL_DIMS} and D in {TP_SYNTH_DIMS} (synthetic), "
        f"N={TP_SMALL_N}; D in {TP_WIDE_DIMS} (synthetic, group size 32), "
        f"N={TP_WIDE_N}; D in {TP_CTA_DIMS} (synthetic, a CTA per combine), "
        f"N={TP_CTA_N}")
    prob64, ts64 = tp_problem(torch.float64)
    truth = tp_reference(prob64, ts64)[1:]
    for N in TP_CHECK_NS:
        for dtype in (torch.float64, torch.float32):
            prob, ts = tp_problem(dtype)
            u_lin = truth.to(dtype=dtype, device=DEVICE)
            fe, se = tp_elements(prob, odt.EK1(order=Q), ts, u_lin, 0, N)
            for kind, el in (("filter", fe), ("smooth", se)):
                for rev in (False, True):
                    x = tuple(torch.flip(e, (0,)) for e in el) if rev else el
                    tp_vs_plain(f"{str(dtype)[6:]} N={N} {kind}"
                                f"{' reversed' if rev else ''}", kind, x)
    for D, q in TP_DIMS:
        for N in TP_DIM_NS:
            for dtype in (torch.float64, torch.float32):
                prob, ts = tp_problem(dtype)
                u_lin = truth.to(dtype=dtype, device=DEVICE)
                fe, se = tp_elements(prob, odt.EK1(order=q), ts, u_lin, 0, N,
                                     plain=False)
                for kind, el in (("filter", fe), ("smooth", se)):
                    tp_vs_plain(f"{str(dtype)[6:]} D={D} N={N} {kind}", kind,
                                el)
    for dtype in (torch.float64, torch.float32):
        prob, ts = tp_problem(dtype)
        u_lin = truth.to(dtype=dtype, device=DEVICE)
        for D, q in TP_SMALL_DIMS:
            fe, se = tp_elements(prob, odt.EK1(order=q), ts, u_lin, 0,
                                 TP_SMALL_N, plain=False)
            for kind, el in (("filter", fe), ("smooth", se)):
                tp_vs_plain(f"{str(dtype)[6:]} D={D} N={TP_SMALL_N} {kind}",
                            kind, el)
        for D, N in ([(D, TP_SMALL_N) for D in TP_SYNTH_DIMS]
                     + [(D, TP_WIDE_N) for D in TP_WIDE_DIMS]
                     + [(D, TP_CTA_N) for D in TP_CTA_DIMS]):
            for kind in ("filter", "smooth"):
                tp_vs_plain(f"{str(dtype)[6:]} D={D} N={N} {kind} "
                            "(synthetic elements)", kind,
                            tp_synth_elements(kind, N, D, dtype, 100 + D),
                            replay=D in TP_CTA_DIMS)
    say(f"== 41. the global time-parallel path: solve_fixed_parallel("
        f"EK1(order={Q})), FitzHugh-Nagumo over {TP_TSPAN}, N={TP_N}, "
        f"iterations={TP_ITERS}, float64 and float32")
    launches, _ = tp_path(odt, ek1=True)
    say(f"== 42. the windowed time-parallel path: solve_fixed_parallel("
        f"EK0(order={Q}), windows={TP_WINDOWS}), N={TP_N}, "
        f"iterations={TP_ITERS}, float64 and float32")
    tp_path(odt, ek1=False)
    say(f"== 43. the time-parallel kernels vs plain and timing, float32, "
        f"N={TP_N} (and the totals scan at N={TP_WINDOW_N}; D in "
        f"{tuple(D for D, _ in TP_DIMS + TP_SMALL_DIMS) + TP_WIDE_DIMS}; "
        f"the CTA-per-combine kernels at D in {TP_CTA_DIMS})")
    ms, p_ms, err, bounds = tp_timing(odt, card)
    # each entry's lines end with its combine's (compiled into every entry)
    print_registers(built["log"], TP_NAMES + TP_GROUP_NAMES + TP_WIDE_NAMES,
                    only="If")
    say(f"== 44. the card's default time-parallel door at D = "
        f"{2 * (TP6_Q + 1)}: solve_fixed_parallel(EK1(order={TP6_Q})), N={TP_N}"
        f", float64 and float32; N={TP6_SEQ_N} against the sequential "
        "smoother")
    tp_dim_door(odt, seq)
    return launches, ms, p_ms, err, bounds


# phase 45: the adaptive EK0 kernel at the orders that the time-parallel
# solves' warm start runs besides 3 (min(q, 3) for q = 1, 2)
WARM_ORDERS = (1, 2)


def warm_orders_vs_plain():
    """Phase 45: ``ek0_adaptive_kernel`` at q = 1 and 2 against its plain
    version at B_CHECK members over TSPAN_ADA (S_ADA save intervals,
    ADA_TOL), float64 and float32: one launch at that order, the counts
    equal on every member, us, stds and lls bit for bit."""
    from odefilters_torch.ops import ek0_adaptive as ea

    for q in WARM_ORDERS:
        for dtype in (torch.float64, torch.float32):
            label = f"{str(dtype)[6:]} ek0_adaptive_kernel at q={q}"
            prob, u0s, ps = inputs(B_CHECK, dtype, TSPAN_ADA)
            m0, ps_t, dt0s = ea._init(prob.f, u0s, ps, TSPAN_ADA, q,
                                      **ADA_TOL)
            c = ea.controller(q, *TSPAN_ADA, S_ADA, dtype,
                              max_iters=MAX_ITERS_FILTER, **ADA_TOL)
            (us_p, sd_p, ll_p, cn_p), p_ms = once(
                lambda: ea.ek0_adaptive_plain(prob.f, m0, ps_t, dt0s, c))
            before = ea.ek0_adaptive.launches_by_order[q]
            us_k, sd_k, ll_k, cn_k = ea.ek0_adaptive(prob.f, prob.field, m0,
                                                     ps_t, dt0s, c)
            torch.cuda.synchronize()
            n = ea.ek0_adaptive.launches_by_order[q] - before
            check(n == 1, f"{label}: {n} launch at order {q} (1 expected)")
            same_counts(label, cn_k, cn_p)
            for what, got, ref in (("us", us_k, us_p), ("stds", sd_k, sd_p),
                                   ("lls", ll_k, ll_p)):
                bitwise(f"{label}, {what} against the plain version", got,
                        ref, strict=True)
            say(f"   {label}: {int(cn_k[0].min())} to {int(cn_k[0].max())} "
                f"accepted steps a member; plain version {p_ms:.1f} ms (once)")


def main() -> int:
    say("== 1. environment")
    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
            "required (there is no CPU fallback)")
        return 2
    import odefilters_torch as odt
    from odefilters_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"   card: {card}")
    say(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")

    say("== 2. build")
    t0 = time.perf_counter()
    built = _build.build()
    _build.load()
    say(f"   built {built['path'].name} in {built['seconds']:.1f} s of nvcc "
        f"({time.perf_counter() - t0:.1f} s in all)")
    for line in built["log"].splitlines():
        if line.startswith("== "):
            say(f"   nvcc {line[3:]}")
        elif ("registers" in line or "spill" in line
              or "Compiling entry" in line):
            say(f"   {line.strip()}")

    say(f"== 3. kernel vs plain, float64, B={B_CHECK}, T={T_CHECK}, "
        f"tspan={TSPAN_CHECK}")
    kernel_vs_plain("f64", Pair(B_CHECK, T_CHECK, torch.float64, TSPAN_CHECK),
                    rtol=1e-10, atol=1e-12)

    say(f"== 4. kernel vs plain, float32, B={B_CHECK}, T={T_CHECK}")
    kernel_vs_plain("f32", Pair(B_CHECK, T_CHECK, torch.float32, TSPAN_CHECK),
                    rtol=1e-4, atol=1e-6)

    say(f"== 5. main path: solve_ensemble, B={B_MAIN}, T={T_MAIN}, "
        f"tspan={TSPAN_MAIN}")
    alg = odt.EK0(order=Q)
    prob32, u0s32, ps32 = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    reset_counts()
    sol32 = odt.solve_ensemble(prob32, alg, u0s32, ps32, n_save=T_MAIN,
                               adaptive=False)
    torch.cuda.synchronize()
    launches = read_counts("ek0_pair_fwd", "ek0_pair_bwd")
    say(f"   launches in the main path's run: {launches}")
    check(all(n >= 1 for n in launches.values()),
          "both kernels launched in the main path's run")
    check(tuple(sol32.us.shape) == (T_MAIN + 1, 2, B_MAIN)
          and tuple(sol32.stds.shape) == (T_MAIN + 1, B_MAIN),
          f"shapes us {tuple(sol32.us.shape)}, stds {tuple(sol32.stds.shape)}")
    prob64, u0s64, ps64 = inputs(B_MAIN, torch.float64, TSPAN_MAIN)
    sol64 = odt.solve_ensemble(prob64, alg, u0s64, ps64, n_save=T_MAIN,
                               adaptive=False)
    torch.cuda.synchronize()
    e_us, e_sd, member = worst_lane("f32 vs f64", sol32.us, sol32.stds,
                                    sol64.us, sol64.stds)
    say(f"   worst member {member}: max |dus| {e_us:.3e}, max |dstd| "
        f"{e_sd:.3e} (all members)")
    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    u0_np, p_np = u0s64.cpu().numpy(), ps64.cpu().numpy()
    us64 = sol64.us.cpu().numpy()
    ref_err = max(
        float(np.abs(us64[:, :, k] - reference_solution(u0_np[k], p_np[k], ts)).max())
        for k in sorted({0, 17, member, B_MAIN - 1})
    )
    check(ref_err <= 1e-5, f"f64 main path vs DOP853 (members 0, 17, "
          f"{member}, {B_MAIN - 1}): max |dus| {ref_err:.3e} <= 1e-5")

    say(f"== 6. timing, float32, B={B_MAIN}, T={T_MAIN}: CUDA events")
    say(f"   card: {card}")
    pair = Pair(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    st_p = pair.fwd_plain()          # also the plain forward's warm-up
    plain_fwd_ms = time_ms(pair.fwd_plain, warmup=0, iters=2)
    plain_bwd_ms = time_ms(lambda: pair.bwd_plain(st_p), warmup=1, iters=2)
    fwd_ms = time_ms(pair.fwd_kernel, warmup=3, iters=20)
    bwd_ms = time_ms(lambda: pair.bwd_kernel(st_p), warmup=3, iters=20)
    solve_ms = time_ms(
        lambda: odt.solve_ensemble(prob32, alg, u0s32, ps32, n_save=T_MAIN,
                                   adaptive=False),
        warmup=3, iters=20,
    )
    say(f"   solve_ensemble (Taylor init + both kernels + epilogue): "
        f"{solve_ms:.3f} ms = {B_MAIN / solve_ms * 1e3:.0f} solves/s")
    for name, k_ms, p_ms in (("forward", fwd_ms, plain_fwd_ms),
                             ("backward", bwd_ms, plain_bwd_ms)):
        say(f"   {name} kernel {k_ms:.3f} ms = {B_MAIN / k_ms * 1e3:.0f} "
            f"solves/s, plain {name} {p_ms:.1f} ms = "
            f"{B_MAIN / p_ms * 1e3:.0f} solves/s")
    say(f"   plain pair {plain_fwd_ms + plain_bwd_ms:.1f} ms = "
        f"{B_MAIN / (plain_fwd_ms + plain_bwd_ms) * 1e3:.0f} solves/s")
    say("   each kernel at this shape vs its plain version "
        "(worst-lane criteria of phase 5):")
    us_p, sd_p = pair.solution(pair.bwd_plain(st_p))
    us_f, sd_f = pair.solution(pair.bwd_plain(pair.fwd_kernel()))
    us_b, sd_b = pair.solution(pair.bwd_kernel(st_p))
    err_fwd = worst_lane("headline forward kernel", us_f, sd_f, us_p, sd_p)[0]
    err_bwd = worst_lane("headline backward kernel", us_b, sd_b, us_p, sd_p)[0]

    say(f"== 7. filter kernels vs plain, float64, B={B_CHECK}, T={T_CHECK}")
    filter_vs_plain(
        "f64", Filter(B_CHECK, T_CHECK, torch.float64, TSPAN_CHECK),
        rtol=1e-10, atol=1e-12, hold_grads=True)

    say(f"== 8. filter kernels vs plain, float32, B={B_CHECK}, T={T_CHECK}")
    filter_vs_plain("f32", Filter(B_CHECK, T_CHECK, torch.float32, TSPAN_CHECK),
                    rtol=1e-4, atol=1e-6, hold_grads=False)

    say(f"== 9. the filter's path: solve_ensemble(EK0(smooth=False)) and "
        f"its gradient, B={B_MAIN}, T={T_MAIN}, tspan={TSPAN_MAIN}")
    counts32, prob32f, u0s32f, ps32f, fsol32, _ = filter_path(odt, torch.float32)
    launches.update({n: counts32[n] for n in
                     ("ek0_filter", "ek0_filter_grad_fwd", "ek0_filter_grad_bwd")})
    _, prob64f, u0s64f, ps64f, fsol64, (g_u, g_p) = filter_path(odt, torch.float64)
    # f32 vs f64 under the pair's criteria on the worst member; the f32
    # filter stds of other members carry the f32 calibration noise (entries
    # of ~1e-6 off by up to 1.95 relative on the CPU plain path), so their
    # count outside the criterion is reported
    dus = (fsol32.us.double() - fsol64.us).abs()
    dsd = (fsol32.stds.double() - fsol64.stds).abs()
    member = int(dus.amax(dim=(0, 1)).argmax())
    e_us = float(dus.max())
    outside = dsd > 1e-3 * fsol64.stds.abs() + 1e-6
    check(e_us <= 1e-4, f"filter f32 vs f64: max |dus| {e_us:.3e} <= 1e-4 "
          f"(worst member {member})")
    check(not outside[:, member].any(),
          f"filter f32 vs f64, worst member {member}: max |dstd| "
          f"{float(dsd[:, member].max()):.3e}, every entry within "
          "1e-3 |std| + 1e-6")
    say(f"   all members: max |dstd| {float(dsd.max()):.3e}, "
        f"{int(outside.sum())} entries outside 1e-3 |std| + 1e-6 (reported); "
        f"worst member's lls f32 {float(fsol32.lls[member]):.6f} vs f64 "
        f"{float(fsol64.lls[member]):.6f} (reported)")
    # The float64 gradient against central differences along a seeded
    # direction. The log-likelihood term carries rounding noise (its
    # innovations sit at the accuracy floor): its difference quotient does
    # not converge at this grid, so the whole loss is reported. The means
    # and stds term is held at 1e-4: its quotient's own noise floor is
    # ~1.4e-5 (CPU plain path, these inputs: 1.04e-5, 1.36e-5, 4.2e-6,
    # 1.3e-5 at steps 1e-4 .. 1e-7; the whole loss 0.29, 2.44, 1.25, 5.87).
    rng = np.random.default_rng(7)
    v_u = torch.tensor(rng.standard_normal(u0s64f.shape), device=DEVICE)
    v_p = torch.tensor(rng.standard_normal(ps64f.shape), device=DEVICE) * ps64f
    alg_f = odt.EK0(order=Q, smooth=False)

    def smooth_part(sol):
        return 0.1 * sol.us[:, 0].sum() + 0.01 * sol.stds.sum()

    def losses64(eps):
        with torch.no_grad():
            sol = odt.solve_ensemble(prob64f, alg_f, u0s64f + eps * v_u,
                                     ps64f + eps * v_p, n_save=T_MAIN,
                                     adaptive=False)
            return float(filter_loss(sol)), float(smooth_part(sol))

    u, p = u0s64f.clone().requires_grad_(), ps64f.clone().requires_grad_()
    gs_u, gs_p = torch.autograd.grad(
        smooth_part(odt.solve_ensemble(prob64f, alg_f, u, p, n_save=T_MAIN,
                                       adaptive=False)),
        (u, p))
    ad = (float((g_u * v_u).sum() + (g_p * v_p).sum()),
          float((gs_u * v_u).sum() + (gs_p * v_p).sum()))
    for eps in (1e-4, 1e-5, 1e-6):
        plus, minus = losses64(eps), losses64(-eps)
        for i, what in enumerate(("whole loss", "0.1 us + 0.01 stds")):
            fd = (plus[i] - minus[i]) / (2 * eps)
            rel = abs(fd - ad[i]) / abs(ad[i])
            text = (f"f64 gradient vs central difference, {what}, step "
                    f"{eps:g}: autograd {ad[i]:.9e}, difference {fd:.9e}, "
                    f"relative {rel:.3e}")
            if eps == 1e-5 and i == 1:
                check(rel <= 1e-4, f"{text} <= 1e-4")
            else:
                say(f"   {text} (reported)")
    # the hand adjoint against the plain torch.func.vjp sweep at full
    # length, with seeded cotangents of us, stds and lls: this holds the
    # log-likelihood's cotangent path that the difference quotient above
    # cannot, at the gradient tolerances of the check shape
    flt64 = Filter(B_MAIN, T_MAIN, torch.float64, TSPAN_MAIN)
    st64 = flt64.grad_fwd_plain()[3]
    (dm0_k, dps_k), (dm0_p, dps_p) = flt64.grad_bwd(st64), flt64.grad_bwd_plain(st64)
    torch.cuda.synchronize()
    name = f"f64 ek0_filter_grad_bwd_kernel vs plain at {B_MAIN} x {T_MAIN}"
    err_adjoint = max(
        close_rows(f"{name}, dm0", dm0_k, dm0_p, 1e-8, 1e-10),
        close_rows(f"{name}, dps", dps_k, dps_p, 1e-8, 1e-10))
    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    u0_np, p_np = u0s64f.cpu().numpy(), ps64f.cpu().numpy()
    us64 = fsol64.us.cpu().numpy()
    ref_err = max(
        float(np.abs(us64[:, :, k] - reference_solution(u0_np[k], p_np[k], ts)).max())
        for k in sorted({0, 17, member, B_MAIN - 1})
    )
    # filter means at dt = 0.04: 2.39e-6 at most over 32 members on the CPU
    # plain path
    check(ref_err <= 1e-5, f"f64 filter means vs DOP853 (members 0, 17, "
          f"{member}, {B_MAIN - 1}): max |dus| {ref_err:.3e} <= 1e-5")

    say(f"== 10. the filter's kernels vs plain and timing, float32, "
        f"B={B_MAIN}, T={T_MAIN}: CUDA events")
    say(f"   card: {card}")
    flt = Filter(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    f_plain_ms = {}
    refs = {}
    refs[None], f_plain_ms["ek0_filter"] = once(flt.primal_plain)
    refs.update({static: flt.primal_plain(static) for static in STATIC})
    refs["grad_fwd"], f_plain_ms["ek0_filter_grad_fwd"] = once(flt.grad_fwd_plain)
    st32 = refs["grad_fwd"][3]
    _, f_plain_ms["ek0_filter_grad_bwd"] = once(lambda: flt.grad_bwd_plain(st32))
    err_filter = outputs_vs_plain(f"f32 at {B_MAIN} x {T_MAIN}", flt, refs,
                                  rtol=1e-4, atol=1e-6)
    err_filter["ek0_filter_grad_bwd"] = err_adjoint
    f_ms = {
        "ek0_filter": time_ms(flt.primal, warmup=3, iters=20),
        "ek0_filter_grad_fwd": time_ms(flt.grad_fwd, warmup=3, iters=20),
        "ek0_filter_grad_bwd": time_ms(lambda: flt.grad_bwd(st32), warmup=3,
                                       iters=20),
    }

    def solve_fwd():
        with torch.no_grad():
            odt.solve_ensemble(prob32f, alg_f, u0s32f, ps32f, n_save=T_MAIN,
                               adaptive=False)

    def solve_grad():
        u, p = u0s32f.clone().requires_grad_(), ps32f.clone().requires_grad_()
        sol = odt.solve_ensemble(prob32f, alg_f, u, p, n_save=T_MAIN,
                                 adaptive=False)
        torch.autograd.grad(filter_loss(sol), (u, p))

    fwd_solve_ms = time_ms(solve_fwd, warmup=3, iters=20)
    grad_solve_ms = time_ms(solve_grad, warmup=3, iters=10)
    say(f"   forward solve (Taylor init + ek0_filter_kernel + epilogue): "
        f"{fwd_solve_ms:.3f} ms = {B_MAIN / fwd_solve_ms * 1e3:.0f} solves/s")
    say(f"   forward + backward (Taylor init, gradient forward, adjoint "
        f"sweep, autograd through the init): {grad_solve_ms:.3f} ms = "
        f"{B_MAIN / grad_solve_ms * 1e3:.0f} gradients/s")
    for name in f_ms:
        say(f"   {name} kernel {f_ms[name]:.4f} ms, plain {f_plain_ms[name]:.1f} ms")

    say(f"== 11. sampler kernels vs plain, float64, B={B_CHECK}, T={T_CHECK}, "
        f"S={S_CHECK}")
    sampler_vs_plain("f64", Sampler(B_CHECK, T_CHECK, torch.float64,
                                    TSPAN_CHECK, S_CHECK),
                     rtol=1e-10, atol=1e-12)

    say(f"== 12. sampler kernels vs plain, float32, B={B_CHECK}, T={T_CHECK}, "
        f"S={S_CHECK}")
    sampler_vs_plain("f32", Sampler(B_CHECK, T_CHECK, torch.float32,
                                    TSPAN_CHECK, S_CHECK),
                     rtol=1e-4, atol=1e-6)

    say(f"== 13. the sampler's path: sample_ensemble, B={B_MAIN}, T={T_MAIN}, "
        f"S = 1 and {S_MAIN}")
    s_ms, s_plain_ms, s_err, s_launches = sampler_path(odt, card, sol32, sol64)
    launches.update(s_launches)

    say(f"== 14. the static pair: solve_ensemble(EK0(diffusionmodel=...)), "
        f"B={B_MAIN}, T={T_MAIN}")
    static_path(odt, card)

    say(f"== 15. EK1 kernels vs plain, float64, B={B_CHECK}, T={T_CHECK}, "
        f"S = 8, 3 and 1")
    ek1_vs_plain("f64", EK1Case(B_CHECK, T_CHECK, torch.float64, TSPAN_CHECK,
                                S_CHECK), rtol=1e-10, atol=1e-12)

    say(f"== 16. EK1 kernels vs plain, float32, B={B_CHECK}, T={T_CHECK}, "
        f"S = 8, 3 and 1")
    ek1_vs_plain("f32", EK1Case(B_CHECK, T_CHECK, torch.float32, TSPAN_CHECK,
                                S_CHECK), rtol=1e-4, atol=1e-6)

    say(f"== 17. the EK1 paths: solve_ensemble(EK1), sample_ensemble(EK1), "
        f"ieks_ensemble, B={B_MAIN}, T={T_MAIN}, tspan={TSPAN_MAIN}")
    launches.update(ek1_path(odt, card))

    say(f"== 18. the EK1 kernels vs plain (T={EK1_PLAIN_T}) and timing "
        f"(T={T_MAIN}), float32, B={B_MAIN}, S={S_MAIN}")
    e_ms, e_plain_ms, e_err = ek1_timing(odt, card, built)

    say(f"== 19. adaptive kernels vs plain, B={B_CHECK}, tspan={TSPAN_ADA}, "
        f"{S_ADA} save intervals, {ADA_TOL}")
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        adaptive_vs_plain(str(dtype).replace("torch.", ""),
                          AdaptiveCase(B_CHECK, dtype), rtol)

    say(f"== 20. the adaptive paths: solve_ensemble(EK0), adaptive, "
        f"B={B_MAIN}, tspan={TSPAN_ADA}, {S_ADA} save intervals, {ADA_TOL}")
    launches.update(adaptive_path(odt, card))

    say(f"== 21. the adaptive kernels vs plain and timing, float32, "
        f"B={B_MAIN}")
    a_ms, a_plain_ms, a_err, a_bounds = adaptive_timing(card)

    say(f"== 22. DiagonalEK1 kernels vs plain, B={B_CHECK}: the fixed grid "
        f"(T={T_CHECK}, tspan={TSPAN_CHECK}, each diffusion) and the adaptive "
        f"kernels (tspan={TSPAN_ADA}, {S_ADA} save intervals, {ADA_TOL})")
    for dtype, rtol, atol, a_rtol in ((torch.float64, 1e-10, 1e-12, 1e-12),
                                      (torch.float32, 1e-4, 1e-6, 1e-5)):
        label = str(dtype).replace("torch.", "")
        ek1d_fixed_vs_plain(label, EK1DFixed(B_CHECK, T_CHECK, dtype,
                                             TSPAN_CHECK), rtol, atol)
        adaptive_vs_plain(label, EK1DAdaptiveCase(B_CHECK, dtype), a_rtol)

    say(f"== 23. the DiagonalEK1 paths: solve_ensemble(DiagonalEK1), fixed "
        f"grid B={B_MAIN}, T={T_MAIN}, and adaptive B={B_MAIN}, "
        f"tspan={TSPAN_ADA}, {S_ADA} save intervals, {ADA_TOL}")
    launches.update(ek1d_fixed_path(odt, card))
    launches.update(adaptive_path(odt, card, EK1DAdaptiveCase))

    say(f"== 24. the DiagonalEK1 kernels vs plain and timing, float32, "
        f"B={B_MAIN} (fixed grid T={T_MAIN})")
    d_ms, d_plain_ms, d_err, d_bound = ek1d_fixed_timing(card)
    da_ms, da_plain_ms, da_err, da_bounds = adaptive_timing(card,
                                                            EK1DAdaptiveCase)

    say(f"== 25. the four new kernels vs plain, B={B_CHECK}, "
        f"tspan={TSPAN_ADA}, {S_ADA} save intervals, {ADA_TOL}: the adaptive "
        f"EK1 kernels and the adaptive sampler (S={S_CHECK} numpy normals, "
        "then zero normals), bit for bit")
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        label = str(dtype).replace("torch.", "")
        adaptive_vs_plain(label, EK1AdaptiveCase(B_CHECK, dtype), rtol,
                          strict=True)
        adaptive_sampler_vs_plain(
            label, AdaptiveSamplerCase(B_CHECK, dtype, S_CHECK), rtol)

    say(f"== 26. the adaptive EK1 and sampler paths: solve_ensemble(EK1), "
        f"sample_ensemble(EK0, adaptive=True), B={B_MAIN}, tspan={TSPAN_ADA}, "
        f"{S_ADA} save intervals, {ADA_TOL}")
    launches.update(adaptive_path(odt, card, EK1AdaptiveCase))
    launches.update(adaptive_sampler_path(odt, card))

    say(f"== 27. the four new kernels vs plain and timing, float32, "
        f"B={B_MAIN}")
    ea_ms, ea_plain_ms, ea_err, ea_bounds = adaptive_timing(
        card, EK1AdaptiveCase, strict_smoother=True)
    sm_ms, sm_plain_ms, sm_err, sm_bound = adaptive_sampler_timing(card)
    print_registers(built["log"], ("ek1_adaptive", "ek1_adaptive_stream",
                                   "ek1_adaptive_smoother",
                                   "ek0_adaptive_sampler"))

    dl_launches, dl_ms, dl_plain_ms, dl_err, dl_bounds = datalik_phases(
        odt, card, built)
    launches.update(dl_launches)
    pd_launches, pd_ms, pd_plain_ms, pd_err, pd_bounds_ = pd_phases(
        odt, card, built)
    launches.update(pd_launches)
    e1_launches, e1_ms, e1_plain_ms, e1_err, e1_bounds = ek1dl_phases(
        odt, card, built)
    launches.update(e1_launches)
    kg_launches, kg_ms, kg_plain_ms, kg_err, kg_bounds = kron_phases(
        odt, card, built)
    launches.update(kg_launches)
    tp_launches, tp_ms, tp_plain_ms, tp_err, tp_bounds = tp_phases(
        odt, card, built)
    launches.update(tp_launches)
    say(f"== 45. the warm start's orders: ek0_adaptive_kernel at q in "
        f"{WARM_ORDERS} vs plain, B={B_CHECK}, tspan={TSPAN_ADA}, {S_ADA} "
        f"save intervals, {ADA_TOL}, float64 and float32, bit for bit")
    warm_orders_vs_plain()
    say(f"== 46. the card's default time-parallel door above D = 32: "
        f"solve_fixed_parallel(EK1(order={Q}), warm_start=0) on a d = "
        f"{TP40_D} chain (D = {TP40_D * (Q + 1)}), tspan={TP40_TSPAN}, "
        f"N={TP40_N}, float64 and float32, against the XLA-form scan")
    tp_cta_door(odt)

    say("== bounds at the timed shape (float32, B={}, T={}, S={})".format(
        B_MAIN, T_MAIN, S_MAIN))
    bounds = kernel_bounds(B_MAIN, T_MAIN, torch.float32, S_MAIN)
    for name, (b_ms, b_by, ops) in bounds.items():
        say(f"   {name}: {ops} operations per step and member; bound "
            f"{b_ms:.4f} ms by {b_by}")
    bounds1 = kernel_bounds(B_MAIN, T_MAIN, torch.float32, 1)
    for name in ("ek0_sampler", "ekd_sampler"):
        b_ms, b_by, ops = bounds1[name]
        say(f"   {name} at S=1: {ops} operations per step and member; bound "
            f"{b_ms:.4f} ms by {b_by}")

    if failures:
        say(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            say(f"  - {f}")
        return 1
    ms = {"ek0_pair_fwd": fwd_ms, "ek0_pair_bwd": bwd_ms, **f_ms, **s_ms,
          **e_ms, **a_ms, "ek1d_filter": d_ms, **da_ms, **ea_ms,
          "ek0_adaptive_sampler": sm_ms, **dl_ms, **pd_ms, **e1_ms, **kg_ms,
          **tp_ms}
    plain_ms = {"ek0_pair_fwd": plain_fwd_ms, "ek0_pair_bwd": plain_bwd_ms,
                **f_plain_ms, **s_plain_ms, **e_plain_ms, **a_plain_ms,
                "ek1d_filter": d_plain_ms, **da_plain_ms, **ea_plain_ms,
                "ek0_adaptive_sampler": sm_plain_ms, **dl_plain_ms,
                **pd_plain_ms, **e1_plain_ms, **kg_plain_ms, **tp_plain_ms}
    errs = {"ek0_pair_fwd": err_fwd, "ek0_pair_bwd": err_bwd, **err_filter,
            **s_err, **e_err, **a_err, "ek1d_filter": d_err, **da_err,
            **ea_err, "ek0_adaptive_sampler": sm_err, **dl_err, **pd_err,
            **e1_err, **kg_err, **tp_err}
    bounds.update(a_bounds)
    bounds.update(da_bounds)
    bounds.update(ea_bounds)
    bounds.update(dl_bounds)
    bounds.update(pd_bounds_)
    bounds.update(e1_bounds)
    bounds.update(kg_bounds)
    bounds.update(tp_bounds)
    bounds["ek1d_filter"] = d_bound
    bounds["ek0_adaptive_sampler"] = sm_bound
    use = ptxas_usage(built["log"])
    kernels = []
    for name in SOURCE:
        regs, spills = kernel_usage(use, name)
        kernels.append(
            {"name": name, "route": "cuda", "source": SOURCE[name],
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms[name],
             "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None,
             "registers": regs, "spill_stores": spills})
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
