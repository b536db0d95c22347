#!/usr/bin/env python3
"""Smoke run of geossl_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Card: print ``nvidia-smi`` name and power limit, build every CUDA kernel
   from ``geossl_tpu_torch/ops/csrc`` (one nvcc per source, in parallel).
2. Kernel parity: each kernel against its plain PyTorch version on the card
   (rtol 1e-4, atol 1e-5 in f32: summation order and, in the symmetric mode,
   atomics differ), on real-geometry inputs with padding and empty tiles,
   occupancy gating on and off, at the bucket sizes and at a pad that is
   no multiple of the 8-atom tile.
   The backward kernels (``cfconv_bwd``, ``ncsn_score_bwd``) and the NCSN
   forward are held to their plain versions as well: per-pair and per-node
   outputs elementwise with rtol 1e-4 and atol 1e-5 times the output's
   largest magnitude (f32 sums over up to N terms in another order: the
   error scales with the summands, not with the element), the head's du
   and each kernel's weight gradients together by relative Frobenius norm
   1e-3 and each weight gradient by 1e-2 (f32 sums over up to B*N^2 pair
   terms that cancel; du and the head's weight gradients also see relu'
   flip where a pre-activation lies within rounding of zero). ``cfconv_bwd``'s
   denv is compared on occupied 8x8 tiles and must be zero on the others
   (the occupancy contract of ``geossl_tpu/ops/pallas_utils.py``);
   ``cfconv_bwd`` runs on the ``max_neighbors=32`` graph of its path (env
   truncated, not symmetric), at B=8 and at the DDM shape (B=128, N=128).
   ``cfconv_bwd_sym`` likewise on LBA complexes (N=256, N=512 and a pad
   of 260), ddist and denv by its placement contract: the plain version's
   true cotangents placed as ``ops/cfconv.place_sym_cotangent`` says (on
   8x8 tiles above the diagonal the sum of a cell's and its mirror's, on
   diagonal tiles the cell's own, below the diagonal and, with gating, on
   empty tiles zero), elementwise with the scaled atol; dx elementwise.
   PaiNN's kernels likewise, at full width (F=128, R=20, cutoff 5):
   ``painn_fwd`` elementwise at rtol 1e-4 / atol 1e-5; ``painn_bwd``'s
   seven per-pair and per-node cotangents elementwise (scaled atol) and
   dWk/dbk by relative norm, its five pair cotangents zero on empty tiles
   with gating on (also on the DDM batch at N=128, a partial batch of 5
   graphs in its 128 slots and the LBA batch at N=512; on the DDM batch two
   launches must agree bitwise in every output); ``painn_stack`` (scaled
   atol) against the per-block plain chain, and in phase 4 at serving's first
   batch of buckets 32, 64 and 128 (128 slots, whatever the route) and on a
   partial batch (5 graphs in 128 slots), two launches bitwise equal at each
   (``painn_stack_shapes:``: its time and bounds at each, and the kernel
   instance it ran, by rows per dense chunk, with ptxas's registers and
   spills); ``painn_stack_train``'s six outputs (q, mu and the four
   residual stacks) at the DDM batch, two launches bitwise equal
   (``painn_stack_train_instances:``: the instance each DDM bucket's step
   runs, with its ptxas). ``schnet_stack`` elementwise
   (rtol 1e-4, atol 1e-5) in its symmetric mode (default graph) and its
   plain mode (``max_neighbors=32`` graph) at B=8, at serving's first batch
   of buckets 32, 64 and 128 (128 slots), on a partial batch (5 graphs in
   128 slots) and on one of very uneven graphs (60 of bucket 32 and 8 of
   bucket 128 at N=128); a second launch must agree with the first at the
   same tolerance (its messages are summed with atomics). ``cfconv_fwd_sym``
   likewise (rtol 1e-4, atol 1e-5, gating off and on) on that partial and
   that uneven batch, a second launch against the first; and, in phase 4,
   at the DDM buckets (B=128, N=32/64/128) and serving's N=512.
   ``cfconv_fwd`` (rtol 1e-4, atol 1e-5, gating off and on) on the
   ``max_neighbors=32`` graph at B=2 (N=128, 256 and a pad of 100; at
   N=128 and 256 also with G=100 Gaussians, above the 64 up to which W1
   stays in shared memory, two launches bitwise equal), in
   phase 4 at serving's N=256 (two launches bitwise equal) and on the DDM
   batch at N=128 (``cfconv_fwd_ddm:``: two launches bitwise equal, its
   time, bounds and launches on the ``max_num_neighbors`` training path).
   ``ncsn_score_bwd`` on the DDM batch (B=128, N=128) and on a partial batch
   of 5 graphs in its 128 slots; on the DDM batch two launches must agree
   bitwise in every output. ``ncsn_score_fwd`` on the same two batches,
   two launches bitwise equal on each. ``painn_fwd``, in phase 4, at every
   shape its paths give it (rtol 1e-4, atol 1e-5; gating as the dispatcher
   sets it): the DDM batches (B=128, N=32/64/128, the clean graph) and
   their partial batch (5 graphs in 128 slots), serving's first batch at
   N=128 and N=512, an uneven batch (60 graphs of bucket 32 and 8 of
   bucket 128 at N=128), and the LBA batch (B=64, N=512, phase 3c), two
   launches bitwise equal at each (``painn_fwd_shapes:``: its time and
   bound at each).
3. Main paths, each with the launch counters reset just before and read
   just after; every kernel of the path must have launched.
   a. Serving: ``Predictor`` at full SchNet width (F=128, L=6, G=51,
      cutoff 10, batch 128, buckets 32..512) with seeded random weights
      serves a store that spans all five buckets (``predict`` and
      ``embed``), then a ``max_neighbors=32`` Predictor serves it again.
      Outputs must be finite, and 8 molecules per bucket are held against
      the plain path on the card. Then the same for a seeded full-width
      PaiNN ``Predictor`` (F=128, 3 blocks, 20 RBF, cutoff 5, the halving
      MLP head). Each backbone takes its whole-stack kernel up to its
      ``serve.*_STACK_MAX_N`` (SchNet 128: ``schnet_stack``, symmetric
      mode, and plain mode with ``max_neighbors``; PaiNN 128:
      ``painn_stack``) and its per-block kernels above; a bucket's last,
      partial chunk is packed to its count rounded up to 8 slots.
   b. Training: ``train.pretrain_geossl.main`` (GeoSSL-DDM at the published
      defaults: SchNet F=128, L=6, G=51, cutoff 10; batch 128, buckets
      32/64/128; NCSN sigma 10 -> 0.01 over 50 levels, anneal 2; GeoSSL
      sigma 0.3, masking 0.3; lr 5e-4) trains one epoch of a synthetic
      Molecule3D store that fills the three buckets, through the
      symmetric CFConv pair (SchNet's dispatcher takes it whenever
      dist/env are symmetric). Every loss must be
      finite; ``model.pth`` must load into a ``Predictor`` that embeds
      finite values. The same driver with ``--max_num_neighbors 32`` (a
      graph that is not symmetric) trains a few steps through the
      plain-mode ``cfconv_fwd``/``cfconv_bwd``. Then one full-width step
      per bucket with kernels, and one ``max_neighbors=32`` step at N=128,
      is held to the same step with the plain versions (the same injected
      noise; loss rtol 1e-4, all gradients together by relative norm 1e-3
      and each parameter's by 1e-2). A gradient must flow through the
      symmetric CFConv (``cfconv_bwd_sym``); a second order through the
      NCSN head (``ncsn_score_loss``) must raise; the stack must refuse
      autograd. Then the same for PaiNN-DDM
      (``--model_3d painn``: ``painn_fwd``/``painn_bwd`` in the backbone,
      the clean geometry's radius graph as both views' pair mask), whose
      whole-stack kernel must refuse autograd. Then one full-width
      DDM-PaiNN step per bucket with both views through the differentiable
      whole stack (``models/painn.stack_train_apply``: ``painn_stack_train``
      forward, ``painn_bwd`` per block in the backward), held to the
      per-block kernel step as above; a second order through it must
      raise (the JAX package has none either). The comparisons run on a freshly seeded DDM
      model: on the trained one, which differs from run to run in its last
      digits, which pre-activations sit within rounding of a relu's kink
      changes between runs, and in one of five runs kinks crossed by one
      side only moved the head kernel's db_d2 by 1.7x its value.
   c. Fine-tunes at N=512: ``train.finetune_lba.main`` at the published
      settings (SchNet F=128, L=6, G=51, cutoff 10; batch 64, bucket 512,
      lr 1e-4, Morton sort on) for 2 epochs of a synthetic LBA store of 160
      complexes (2 training batches, 16 val and 16 test complexes) from the
      DDM-SchNet ``model.pth`` of b: ``cfconv_fwd_sym`` and
      ``cfconv_bwd_sym`` must launch, losses and metrics be finite, and the
      written ``model.pth`` must give the run's best val MSE again under
      ``--eval_only``. The same for ``train.finetune_lep.main`` at its
      defaults (batch 16, bucket 512) for 1 epoch of 64 synthetic pairs,
      and for 2 PaiNN LBA steps (``painn_fwd_sym``/``painn_bwd_sym`` at
      N=512: PaiNN's route from N=256) from the DDM-PaiNN ``model.pth``. Then one full-width LBA-SchNet step
      at N=512 with kernels is held to the same step with the plain
      versions (in chunks of 4 graphs; tolerances as in b) on a freshly
      seeded net. On the same batch of 64 complexes, a freshly seeded
      full-width LBA-PaiNN net (F=128, 3 blocks, 20 RBF, cutoff 5): block
      0's ``painn_fwd`` and ``painn_bwd`` against their plain versions (in
      graph chunks; tolerances as in 2), then one LBA-PaiNN step (through
      the symmetric pair, its route) against the plain step (in chunks of
      2 graphs; tolerances as in b).
   d. The symmetric PaiNN pair on the same LBA-PaiNN inputs (B=64, N=512:
      symmetric dist/gate, antisymmetric directions), through the
      dispatcher ``painn_message(symmetric=True)`` and the wrappers, and on
      a serving-like partial batch at N=256 (the store's 11 molecules of
      that bucket in 128 graph slots): ``painn_fwd_sym`` against the plain
      version and against ``painn_fwd`` (tolerances as ``painn_fwd``),
      ``painn_bwd_sym`` against the plain cotangents placed
      (``place_sym_cotangent``: ddist/dgate symmetric, the three ddir
      antisymmetric; tolerances as ``painn_bwd``), gating off and on, and
      a second launch of each against the first (the five pair
      cotangents and dWk/dbk bitwise; dq, dmu, dx and dmu, summed with
      atomics, within the same tolerances); then a scalar loss
      through ``pairwise_directions``, the cosine-cutoff gate and the
      symmetric pair, whose gradients to the positions, x, mu, Wk and bk
      must match the same chain through ``painn_fwd``/``painn_bwd`` within
      relative norm 1e-5 (the placement's real test: a sign error in the
      direction terms passes every forward check).
   e. The QM9 fine-tune at bucket 32: ``train.finetune_qm9.main`` at the
      published protocol (``scripts/finetune_qm9.sh``: batch 128, lr 5e-4
      cosine, MAE loss; task mu; buckets 32/64/128) for 1 epoch of 4,096
      synthetic QM9 molecules (3-29 atoms; split
      ``qm9_random_customized_01``: 3,443 train, 313 val, 340 test), once
      per backbone at full width from the DDM ``model.pth`` of b:
      ``cfconv_fwd_sym``/``cfconv_bwd_sym`` (SchNet) and
      ``painn_fwd``/``painn_bwd`` (PaiNN) must launch, losses and MAEs be
      finite. The best ``model.pth`` (with ``y_mean``/``y_std``) is served
      by ``Predictor.from_checkpoint``, through ``schnet_stack`` /
      ``painn_stack``, and its test predictions held to the driver's
      ``evaluation_best.npz`` (made by the per-block kernels) within rtol
      1e-4 and atol 1e-5 times y_std; one step with kernels on a freshly
      seeded net is held to the plain step (tolerances as in b). Then the
      ``qm9:`` line (train mol/s, median of 3 untraced steps; eval mol/s
      over the val split; one traced step's device ms, port-kernel ms and
      idle share) and, for SchNet, a ``top_ops:`` line that also lists
      the elementwise ``cos`` kernel: the envelope must be made once per
      forward (one ``cos`` launch per step).
   f. The MD17 energy+force fine-tune at bucket 32:
      ``train.finetune_md17.main`` at the published protocol
      (``submit_finetune_md17_schnet.sh``: train batch 5, eval batch 128,
      lr 5e-4, loss 0.05 L1(E) + 0.95 L1(F), forces -dE/dpos through the
      model with a double backward) for 1 epoch of 2,400 synthetic frames
      of aspirin's 21 atoms (split ``md17_split``: 1000 train, 1000 val,
      400 test), once per backbone at full width from the DDM
      ``model.pth`` of b: ``cfconv_fwd_sym``/``cfconv_bwd_sym`` (SchNet)
      and ``painn_fwd``/``painn_bwd`` (PaiNN) must launch, losses and E/F
      MAEs be finite. One step on a freshly seeded net must launch the
      forward kernel once per block and the backward kernel twice (the
      force, then the loss's backward through it; the second order runs
      as autograd over the plain backward) and nothing else, and is held
      to the plain step (tolerances as in b). The best ``model.pth``
      through ``Predictor.predict_forces`` (the per-block kernels and
      their backwards, nothing else) on the test split: energies and
      forces held to the plain path on the same weights within rtol 1e-4
      and atol 1e-5 times their largest magnitude. Then the ``md17:``
      line (train frames/s, median of 3 untraced steps; eval and
      predict_forces frames/s; one traced step's device ms, port-kernel
      ms and idle share; the E/F MAEs) and its ``top_ops:`` line. Last,
      the four second orders (``cfconv_bwd``, ``cfconv_bwd_sym``,
      ``painn_bwd``, ``painn_bwd_sym``'s) at the MD17 shape: a force
      loss's gradients to the positions and block 0's inputs through each
      kernel Function (its forward once, its backward twice) against
      autograd through the plain chain, elementwise at rtol 1e-4 and
      atol 1e-5 times each tensor's largest magnitude.
   g. The pretraining objectives beyond DDM, per backbone at full width
      (SchNet F=128, L=6, G=51; PaiNN's defaults): ``pretrain_geossl``'s
      InfoNCE, EBM_NCE and RR and ``pretrain_baselines``' supervised,
      charge, distance, torsion, infograph and contextpred, at the drivers'
      defaults. First, for each, one step at bucket 128 (B=128, the DDM
      training batch) of a freshly seeded module with kernels against the
      same step with the plain versions, the same seeded draws (the
      perturbed view; charge's, torsion's and contextpred's draws) and
      weights; the plain step runs its backbones in chunks of 16 graphs
      under activation checkpointing (the contrastive losses couple the
      whole batch, so the step is not split); tolerances as in b, and
      RR's BatchNorm statistics after the step elementwise at rtol 1e-4 /
      atol 1e-5. Then contextpred's substruct and context node masks on
      that batch (holes in the middle of a graph, not a prefix of its
      atoms): ``cfconv_fwd_sym``/``cfconv_bwd_sym`` and
      ``painn_fwd``/``painn_bwd`` on block 0's inputs under each mask
      against their plain versions (tolerances as in 2; dist/env and
      dist/gate must stay symmetric), one ``contextpred_masks:`` line.
      Then each driver's ``main()`` for one epoch of 256 synthetic
      Molecule3D molecules (buckets 32/64/128, batch 128; pretrain_baselines
      with ``--steps_per_call 8``, every step of it in a CUDA graph replay,
      counted by ``ChainStep``'s calls): the backbone's
      kernel pair must launch, losses be finite and ``model.pth`` be
      served by a ``Predictor``; then its module's step at bucket 128:
      each kernel's launches per step, the median of 3 synchronized steps,
      one traced step (device ms, port-kernel ms, idle share), one
      ``pretrain:`` line per objective and backbone with the card's name
      and power limit.
   h. The rest of serving, per backbone at full width. First the custom
      ops' host cost: ``cfconv_fwd`` (symmetric, one graph of 32 atoms)
      through its ``torch.library`` op and through the launch code, five
      rounds in turns (``custom_op_overhead:``; eager calls run the launch
      code directly, ``ops/_launch.launch``: the route above 5 us).
      ``Predictor.predict_pairs`` on 64 synthetic LEP pairs at bucket 512
      and one 128x512 pair from phase 3c's LEP-SchNet ``model.pth`` (PaiNN:
      the DDM-PaiNN backbone with a seeded dual head), held to the same
      pairs through the plain versions at rtol 1e-4 / atol 1e-5·max: the
      probabilities, and the logits of both towers through the route and
      through the plain versions on the same packed chunks (a seeded head
      may saturate the sigmoid) (``pairs:`` lines). Then ``export.seal`` of phase 3e's QM9
      ``model.pth`` over the ladder (32, 128, 512) in predict, embed and
      forces, and of the LEP checkpoint in pairs over [512];
      ``SealedPredictor.load``; each mode on the serving store (pairs on
      the 64 pairs) held to the live Predictor at the same tolerance; the
      port's kernels counted by the profiler in a live and a sealed pass
      per mode (each kernel's largest count over three traced passes: the
      profiler may drop a record), which must agree (the serving kernels of the
      backbone's route must run inside the programs); a 128x512 pair must
      raise (not sealed); ``sealed:`` lines (export s, artifact MB, load
      s, first and steady pass against the live Predictor). Last, ``serve``
      on an ``.sdf`` that the phase writes, from the QM9-SchNet
      ``model.pth`` and from its artifact, against ``predict`` on the same
      file.
   i. The host runtime. ``packer:``: the C++ packer (``native/``) bitwise
      against the NumPy pack on a QM9 store at bucket 32 (B=128) and a
      Molecule3D stand-in at 32/64/128; the fused BFS pack's kept count,
      kept atoms in order and in no more pieces than the bond graph has,
      and the per-record BFS mask's relabelled bonds; ms per batch of each
      packer (host clock). ``graph_parity:``: per ported driver step and
      backbone (QM9, DDM and the six baseline objectives at bucket 32,
      MD17 at batch 5, LBA at 16 complexes and LEP at 16 pairs of bucket
      512; DDM and the baselines with their device generator; DDM-SchNet
      once more under ``--compute_dtype bfloat16``), two calls
      of 8 steps replayed through CUDA graphs (``train/common.ChainStep``)
      against 16 eager steps from the same weights on the same batches:
      losses and every parameter by relative norm (1e-3 in all, 1e-2
      each, or within 10x the run-to-run spread, sampled from up to five
      pairs of eager runs and one of graph runs; the backbone's kernel
      pair, bf16: its bf16 instances, must be
      in the baselines' and the bf16 case's graphs; each case's seconds).
      ``profile_dir:``: one ``pretrain_geossl --profile_dir
      --steps_per_call 8`` epoch on 256 molecules; the trace must exist and
      not be empty. ``host_runtime:``: QM9-SchNet/PaiNN, DDM-SchNet/PaiNN
      and contextpred-SchNet/PaiNN (the heaviest baseline: two backbones a
      step) at bucket 32 (B=128), MD17-SchNet/PaiNN at batch 5, each in
      three modes over epochs of 16 steps: (a) the parent's loop (NumPy
      packing and BFS, a blocking upload from pageable memory, eager
      steps), (b) the C++ packer and ``parallel/mesh.prefetch`` (pinned,
      non-blocking uploads), eager steps, (c) (b) with ``--steps_per_call
      8`` as CUDA graphs; step ms (median of 3 untraced epochs after a
      warm-up epoch), device busy ms per step and the idle share of one
      traced epoch.
   j. Multi-device running (``parallel:``), on the one card. (a) Two gloo
      ranks share it: ``pretrain_geossl --num_devices 2 --dist_backend
      gloo`` (the launcher's spawn) trains one full-width DDM-SchNet epoch
      of 2 steps at bucket 128; its epoch loss (rtol 1e-4) and backbone
      (relative norm 1e-3 in all; a parameter beyond 1e-2 only within 10x
      the spread of two one-process runs) are held to the one-process run.
      (b) Pair parallelism: ``finetune_lba --pair_devices 2 --dist_backend
      gloo`` (the launcher's spawn: two gloo ranks on a (data 1, pair 2)
      mesh) trains one LBA step per backbone at B=64, N=512 (each rank's
      message passes on its j-stripe [64, 512, 256] through the plain-mode
      kernels #1/#2, #8/#9; no symmetric or stack kernel may launch); its
      loss and first-step gradients (from its ``state.pth``) are held to
      the one-process run of the same command line as in 3b; the four
      stripe kernels held to their plain versions at [64, 512, 256]
      (gating off and on) and timed there and on the whole grid
      (``stripe_kernels:``, with the card; their rows on the kernels line
      carry ``pair_launches`` and ``stripe``).
      The three launchers of (a) and (b) run at once, beside (a) and (b)'s
      one-process runs (their seconds are so measured); the script ends
      them, ranks included, if it stops first.
      (c) An NCCL group of one rank: ``graph_parity:``'s check for QM9-PaiNN
      and DDM-SchNet with the mesh's collectives in every step, the
      gradient all_reduce captured in the CUDA graphs
      (``parallel nccl_graph_parity:``).
   k. Tools (``tools:``, at most 120 s). (a) ``python -m geossl_tpu_torch
      doctor --json --mesh 2`` in a subprocess: rc 0, platform cuda, every
      kernel of the launch counters in its ``checked`` list (``doctor:``:
      seconds, the worst kernel error). (b) A synthetic Molecule3D raw tree
      (2,048 molecules of 4-100 atoms, an unparseable block every 17th) built
      by ``python -m geossl_tpu_torch data molecule3d --subset 1024``
      (``molecule3d:``: build seconds), then one DDM-SchNet epoch of
      ``pretrain --dataset Molecule3D_1024`` on that cache: finite losses,
      #3/#4/#6/#7 launched. (c) ``evalkit --budget smoke`` from phase 3b's
      DDM-SchNet ``model.pth``: one finite cell per family; a second call
      resumes in under 10 s and launches no kernel (``evalkit:``). (d)
      ``flops:``: per backbone, one DDM step at bucket 128 (B=128) traced
      for its device-busy ms, with ``utils/flops.ddm_step``'s dense and
      executed counts (``executed_pair_fraction`` of the step's env or gate
      and of its pair selection): dense-effective and executed TFLOP/s and
      the executed share of the TF32 peak, which must stay <= 1.0. (e)
      ``se3_basis:``: ``ops/se3_basis.get_basis`` on CUDA f32 against the
      CPU f64 result, max relative error (per key, by the key's largest
      magnitude) <= 1e-5.
4. Measurements: serving mol/s per bucket (steady state, synchronized) and
   one traced pass per bucket (torch.profiler: device busy time, the
   port's kernels' share, idle share); training mol/s per bucket (median of
   3 synchronized steps after a warm-up) and one traced step per bucket,
   for both backbones, and the kernels with the most device time at each
   path's largest bucket; DDM-PaiNN mol/s per bucket through the stack and
   through the per-block kernels (``train_stack:`` lines, median of 3
   steps each, in turns); the symmetric pair's and the plain pair's kernel
   times at the LBA shape and the LBA-PaiNN step's device ms through each
   route (``painn_sym_vs_plain_kernels:``; ``routed`` is the pair PaiNN's
   dispatcher picks there, the measurement its route follows) and, for the
   CFConv, at the DDM buckets (B=128, N=32/64/128) and the LBA shape
   (``cfconv_sym_vs_plain_kernels:``, forward and backward of each pair:
   the measurement SchNet's route follows; ``routed`` is the pair the
   dispatcher picks), after ``cfconv_fwd_sym`` and ``cfconv_bwd_sym`` are
   held to their plain versions on those DDM inputs (tolerances as in 2,
   gating off and on), and ``cfconv_fwd_sym``'s time, plain time, bound and
   launches on its training path (``cfconv_fwd_sym_ddm:``); the serving
   routes head to head at buckets 32, 64 and 128 (``serving_route:``: the
   whole representation through the stack and through the per-block
   kernels, and ``routed``, the Predictor's pick; the measurement that
   ``serve.SCHNET_STACK_MAX_N`` / ``PAINN_STACK_MAX_N`` follow) and
   ``schnet_stack``'s two modes at serving's N=128 (``schnet_stack_modes:``);
   fine-tune
   complexes/s (LEP: pairs/s) at N=512,
   one traced step and its top device kernels, for LBA (both backbones)
   and LEP;
   each kernel's time at the shape its path gives it, beside its plain
   version's time and its bound (f32 CUDA-core peak and HBM rate; the
   pairs with nonzero env or sel, env read whole and the other pair grids
   on its occupied 8x8 tiles; with symmetric dist/env each pair's filter
   once and the upper triangle read; for the tensor-core CFConv backward,
   ``bound_basis`` "tf32_tensor_core+f32": its products once at the TF32
   tensor-core peak, its elementwise terms at the f32 peak; likewise
   ``cfconv_fwd``, ``schnet_stack``, ``painn_fwd``, ``painn_bwd``,
   ``painn_fwd_sym``, ``painn_bwd_sym``,
   ``painn_stack``, ``painn_stack_train``, ``cfconv_fwd_sym`` (also on the
   ``cfconv_fwd_sym_ddm:`` line), ``ncsn_score_fwd`` and
   ``ncsn_score_bwd``; ``bound_ms_f32`` beside it counts every operation at
   the f32 peak), and ptxas's registers and spills per kernel. Those kernels compute their products in
   3xTF32 on the tensor cores and are held to the same tolerances as every
   other kernel. The NCSN rows count their launches over both DDM epochs
   (SchNet and PaiNN).
5. Any Gaussian count (``gaussians:``, at most 150 s). The CFConv kernels
   #1-#5 take any ``--num_gaussians``: up to 64 the instances above, above
   64 the ones that stream W1 in chunks of 32 rows. (a) SchNet's paths at
   full width (F=128, 6 blocks, cutoff 10) at G=100 and G=300, the launch
   counters reset before and read after: ``pretrain_geossl
   --num_gaussians G`` (DDM, buckets 32/64/128, batch 128) for one epoch of
   256 molecules, the same with ``--max_num_neighbors 32``, one
   ``finetune_lba --num_gaussians G`` step at N=512 (80 complexes), and a
   seeded ``Predictor`` and its ``max_neighbors=32`` twin serving the store
   over buckets 32..512 (each held to the plain path on 8 molecules per
   bucket, rtol 1e-4 / atol 1e-5 x max); all five kernels must launch. (b)
   At G=65, 100 and 300, each kernel at its path's shapes against its plain
   version (chunked), gating off and on, with the tolerances of G=51 (2,
   above): ``cfconv_fwd`` at serving's N=256 and on the DDM
   ``max_num_neighbors 32`` batch (B=128, N=128), ``cfconv_bwd`` on that
   batch, ``cfconv_fwd_sym`` on the DDM batch, ``cfconv_bwd_sym`` at the
   LBA shape (B=64, N=512), ``schnet_stack`` in both modes at serving's
   N=128 batch; a second launch bitwise equal to the first where the
   kernel writes each output once (#1, #2, #4 but dx), within the tolerance
   where it adds with atomics (#3, #5, #4's dx). At G=100 and 300 each is
   timed with its plain version and bound (counted as the G=51 rows). (c)
   One full-width DDM-SchNet step at bucket 128 with G=300 (a freshly
   seeded module) held to the plain step (tolerances as in 3b), and the
   device ms of one traced step at G=300 and at G=51.

6. The bfloat16 modes (``bf16:``, at most 150 s). ``--filter_mxu bf16``
   and ``--compute_dtype bfloat16`` run the bf16 instances of #1-#4 (the
   filter products on bf16 operands, f32 accumulation; launches counted
   as ``<kernel>_bf16``). (a) The main paths, counters reset before and
   read after: a DDM-SchNet epoch in compute_dtype (the symmetric pair),
   one in filter_mxu with ``--max_num_neighbors 32`` (the plain-mode pair),
   a DDM-PaiNN epoch and one LBA epoch per backbone in compute_dtype, and a
   seeded Predictor per mode over buckets 32..512: every bf16 instance
   launches, no f32 CFConv instance does, no Predictor launches a stack;
   each Predictor against its plain path on 8 molecules per bucket, one
   seal of the compute_dtype Predictor against the live one. (b) Each bf16
   instance against its plain bf16 version at G=51 and G=300, gating off
   and on: #1/#2 on the DDM ``max_num_neighbors 32`` batch (B=128, N=128),
   #3 on the DDM batch, #4 at the LBA shape (B=64, N=512; the placement
   contract), at the JAX package's own bound for the mode: outputs within
   rtol 2e-3 / atol 2e-3 x max, each gradient's mean error within 5% of
   the f32 gradient's mean magnitude and its relative norm within 1e-2.
   (c) Per mode, a DDM-SchNet step per bucket against the same step through
   the plain bf16 versions (loss 1e-2 relative, gradients 5e-2 relative
   norm) and against the f32 step with the same weights (the JAX package's
   bf16 drift bounds). (d) ``bf16_step:``, the DDM-SchNet step's device ms
   at bucket 128 in f32 and in both bf16 modes, traced in turns.

7. Any width (``widths:``, at most 120 s). SchNet and the DDM head at
   emb_dim = num_filters = 256 (#1-#4 in 2 x 2 column blocks of 128, 4
   launches a call; #6/#7 in the kE = 256 instance, counted as
   ``<kernel>_e256``) and at 96 (#1-#7 zero-padded into their 128
   instances). (a) Per width, counters reset before and read after: a
   DDM-SchNet epoch of ``pretrain_geossl --emb_dim W --num_filters W``
   (256 molecules, buckets 32/64/128, batch 128; exactly 2 x 6 x k^2
   launches of #3 and of #4 per step, none of #1/#2, the head's launches
   in its width's instance only), one with ``--max_num_neighbors 32`` (#1,
   #2), and a seeded Predictor and its ``max_neighbors=32`` twin serving
   the store over buckets 32..512 (F=256: the per-block route at every
   bucket, no stack launch; F=96: the padded stack up to N=128), each held
   to the plain path on 8 molecules per bucket (rtol 1e-4, atol 1e-5 x
   max). (b) One DDM step at bucket 128 per width against the plain step
   (as 3b). (c) #1-#5 at each width against their plain versions at the
   shapes of phase 5 (block 0 of a seeded model at the width; x and the
   cotangents are phase 5's projected to the width by a seeded matrix),
   with the F=128 rows' tolerances, in f32 at G=51 (timed: the kernel
   table's ``<kernel>_f256`` / ``_f96`` rows, bounds counted at the user's
   width) and G=300 and in bf16 at G=51 (#5 at F=96 only; #2/#4's bf16
   backwards at F=96 only: above 128 they are phase 9's); #6/#7 at E=256
   and E=96 on the DDM batch of a seeded DDM at the width (timed:
   ``ncsn_score_*_e256`` / ``_e96``, with the instance's shared bytes);
   ptxas of the kE = 256 instance. (d) The device ms of one DDM step at
   bucket 128 at widths 256, 96 and 128. (e) The refusals above the
   limits: ``pretrain_geossl --model_3d painn --painn_n_rbf 1`` and
   ``models/painn.stack_train_apply`` at F = 256, each naming its flag or
   width.

8. PaiNN at any width and any RBF count (``painn_widths:``, at most 240
   s). #8-#11 at emb_dim = n_atom_basis = 256 (k = 2 column blocks of
   128, 2 launches a message call), #8-#12 at 96 (zero-padded into the
   128 kernels; the stack up to N=128) and at n_rbf 32 and 64 with emb_dim
   128 (the streamed instances: the filter product in 2 and 3 passes of
   at most 32 K rows). (a) Per setting, counters reset before and read
   after: a seeded Predictor serving the store over buckets 32..512 (F =
   256: the per-block route at every bucket, no stack launch) held to the
   plain path on 8 molecules per bucket (rtol 1e-4, atol 1e-5 x max), and
   its forces on two LBA complexes at N=512 (#10/#11) held to the plain
   forces; k launches per message call. (b) One DDM-PaiNN step at bucket
   128 per setting against the plain step (2 x 3 x k launches of #8 and
   #9), and at F = 256 one LBA-PaiNN step at N=512 (#10/#11) against the
   plain step computed in chunks of 2 complexes. (c) #8-#12 per setting
   against their plain versions with the F = 128 rows' tolerances (#8/#9
   on the DDM batch, #10/#11 on the LBA batch, #12 at serving's N=32 and
   in residual mode on the DDM batch), each a second launch against the
   first; timed at 256/20, 96/20 and 128/64: the kernel table's rows
   ``<kernel>_f256`` / ``_f96`` / ``_r64``, bounds counted at the user's F
   and R, launches from (a) and (b), ptxas of the instance each runs. (d)
   The device ms of one DDM-PaiNN step at bucket 128 at 128/20, 256/20,
   96/20 and 128/64.

9. The last width refusals (``widths_final:``, at most 120 s): the two
   settings the training drivers once refused on CUDA, the bf16
   CFConv backwards (#2/#4) above F = 128, in their hidden-block instance
   (``csrc/cfconv_bwd_bf16w.cu``, counted as ``<kernel>_bf16w``, k =
   ceil(F / 128) launches a call), and the DDM head (#6/#7) above E = 256,
   in its streamed instance (``csrc/ncsn_score_wide.cu``, counted as
   ``<kernel>_wide``). (a) Counters reset before each and read after: one
   epoch of ``pretrain_geossl`` at emb_dim = num_filters = 512, of
   ``pretrain_geossl --model_3d painn --emb_dim 384``, of ``pretrain_geossl
   --emb_dim 256 --num_filters 256`` with ``--compute_dtype bfloat16`` and
   with ``--filter_mxu bf16 --max_num_neighbors 32`` (128 synthetic
   molecules, buckets 32/64/128, batch 128), one step of ``finetune_lba
   --num_filters 384 --filter_mxu bf16`` (B=64, N=512): each new instance
   exactly its launches a call per call, the instances it replaces none;
   and ``Predictor.predict_forces`` of a seeded bf16 F = 256 model on two
   complexes at N=512 against the plain forces (phase 6's bounds). (b)
   Each command's step at bucket 128 (LBA: B=64, N=512) against its plain
   step computed in graph chunks (f32: RTOL / GRAD_RTOL; bf16: phase 6's
   step tolerance). (c) #2/#4's hidden-block instance against its plain
   version (``cfconv_bwd_bf16_blocks_reference``) at F = 256 and 384, G =
   51 and 300 (#2 on the DDM ``max_num_neighbors 32`` batch, #4 at the LBA
   shape: all 64 complexes at F = 256 / G = 51, 8 of them otherwise), with
   phase 6's bf16 tolerances, timed at F = 256 / G = 51 (the kernel
   table's ``<kernel>_bf16w_f256`` rows, bounded at the bf16 peak); #6/#7's
   streamed instance at E = 300, 384 and 512 on the DDM batch with phase
   2's tolerances, two launches bitwise equal, timed at 384 and 512
   (``ncsn_score_*_wide_e384`` / ``_e512``). (d) The device ms of one DDM
   step at bucket 128 per DDM command; the new instances' shared memory
   (the C query: constant in F and E) and ptxas.

The line before the last is the kernel table as JSON (thirteen kernels,
every Pallas kernel of the JAX package, then #1-#5 at G=100 and G=300 as
``<kernel>_g100`` / ``_g300`` with their phase-5 launches and shapes,
then #1-#4's bf16 instances at G=51 as ``<kernel>_bf16`` with their
phase-6 launches, bounded at the bf16 tensor-core peak, then phase 7's
rows at F = E = 256 and 96 with their launches, then phase 8's PaiNN rows
at F = 256, F = 96 and R = 64 with theirs, then phase 9's rows (#2/#4's
hidden-block instance at F = 256, #6/#7's streamed instance at E = 384 and
512) with theirs;
``qm9_launches``: each kernel's
launches over both QM9 epochs of phase 3e; ``md17_launches``: each
kernel's launches in one MD17 training step of phase 3f, both backbones;
``pretrain_launches``: each kernel's launches in one step at bucket 128 of
each objective of phase 3g, per ``<backbone>/<objective>``;
``baseline_graph_launches``: each kernel's launches in phase 3g's
``pretrain_baselines --steps_per_call 8`` epoch per ``<backbone>/<objective>``
(the graphs' captures and their warm-up steps: replays count nothing);
``pairs_launches``: each kernel's launches in phase 3h's first live pairs
pass, per backbone; ``sealed_launches``: each kernel's launches inside the
sealed programs over phase 3h's sealed passes (the profiler's count), per
backbone; ``pair_launches`` and ``stripe``: each kernel's launches in
phase 3j's pair runs (rank 0's: the step and both evaluations) and its row
at the stripe shape; ``second_order``: how
a backward kernel's Function is differentiated); the
last line is
``{"ok": true, "device": {...}}``. The whole output is also written to
``runs/chip_smoke.log``.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

RTOL, ATOL = 1e-4, 1e-5
# weight gradients, together (each tensor: 10x): relative Frobenius norm
GRAD_RTOL = 1e-3
# a gradient that is zero in exact arithmetic: its norm against the whole's
ZERO_GRAD_RTOL = 1e-5
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, TF32 on the
# tensor cores (dense), HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores (dense)
PEAK_BYTES = 3.35e12
SEED = 0
# the backward kernels whose Function takes a double backward, and how
SECOND_ORDER = dict.fromkeys(
    ("cfconv_bwd", "cfconv_bwd_sym", "painn_bwd", "painn_bwd_sym"),
    "autograd over the plain backward (the JAX package's XLA *_bwd_bwd)")
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class _Tee:
    """Writes to several streams: the console and the run's log file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def cuda_time_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """(wall s, device busy s, port kernels s) of one call of fn under
    torch.profiler; busy sums every device activity (kernels and copies),
    not the user annotations on the device's timeline (Adam's
    ``Optimizer.step`` range spans its own kernels: counting it would count
    them twice). The sums read the profiler's raw events: ``prof.events()``
    would first build an event for every CPU op as well (seconds a call on
    an eager epoch; the same sums, checked on the H100)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = ours = 0
    for e in prof.profiler.kineto_results.events():
        # the events prof.events() drops: memory records, hidden events
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.is_hidden_event() \
                or e.name() in ("[memory]", "[OutOfMemory]"):
            continue
        busy += e.end_ns() - e.start_ns()
        if "geossl::" in e.name():
            ours += e.end_ns() - e.start_ns()
    return wall, busy * 1e-9, ours * 1e-9


def print_top_ops(fn, model_3d, path, bucket, top=10, also=None):
    """The kernels with the most device time in one more traced call of fn
    (the path's largest bucket: where the device is busiest), and those
    whose name ``also(name)`` picks wherever they rank; returns the
    picked ones."""
    from geossl_tpu_torch.utils.profiling import top_device_ops

    rows = top_device_ops(fn, None, 0)
    picked = [[name, ms, count] for name, ms, count in rows
              if also is not None and also(name)]
    ops = [[name, ms, count] for name, ms, count in rows[:top]]
    ops += [r for r in picked if r not in ops]
    print("top_ops: " + json.dumps({"model": model_3d, "path": path,
                                    "bucket": bucket, "ops_ms_calls": ops}))
    return picked


def pair_work(dist, env):
    """(ordered pairs with env != 0, pairs whose filter network the function
    needs, cells of env it must read, cells of each other pair grid it must
    read) for this run's inputs. env (PaiNN's gate) is read whole to find
    the 8x8 tiles that hold a nonzero env; dist and the direction grids
    only on those tiles. When dist and env are symmetric, one filter serves
    both directions of a pair and the upper triangle (diagonal included)
    holds all of each grid (the directions are antisymmetric)."""
    import torch

    nz = env != 0
    nnz = int(nz.sum())
    occ = tile_occupied(env)
    b, n, _ = env.shape
    if torch.equal(env, env.transpose(1, 2)) and \
            torch.equal(dist, dist.transpose(1, 2)):
        return (nnz, int(torch.triu(nz).sum()), b * n * (n + 1) // 2,
                int(torch.triu(occ).sum()))
    return nnz, nnz, b * n * n, int(occ.sum())


# kernel -> (library, mangled-name prefix of its entry function)
KERNEL_ENTRIES = {
    # the CFConv kernels' G <= 64 f32 instances (..._g100 / _g300 below: the
    # instances that stream W1; ..._bf16: the bf16 instances, phase 6)
    "cfconv_fwd": ("cfconv_fwd", "_ZN6geossl17cfconv_fwd_kernelILb0ELb0E"),
    "cfconv_fwd_sym": ("cfconv_fwd",
                       "_ZN6geossl21cfconv_fwd_sym_kernelILb0ELb0E"),
    "schnet_stack": ("schnet_stack", "_ZN6geossl19schnet_stack_kernelILb1ELb0E"),
    "cfconv_bwd": ("cfconv_bwd", "_ZN6geossl17cfconv_bwd_kernelILb0ELb0ELb0E"),
    "cfconv_bwd_sym": ("cfconv_bwd",
                       "_ZN6geossl17cfconv_bwd_kernelILb1ELb0ELb0E"),
    "cfconv_fwd_bf16": ("cfconv_fwd",
                        "_ZN6geossl17cfconv_fwd_kernelILb0ELb1E"),
    "cfconv_fwd_sym_bf16": ("cfconv_fwd",
                            "_ZN6geossl21cfconv_fwd_sym_kernelILb0ELb1E"),
    "cfconv_bwd_bf16": ("cfconv_bwd",
                        "_ZN6geossl17cfconv_bwd_kernelILb0ELb0ELb1E"),
    "cfconv_bwd_sym_bf16": ("cfconv_bwd",
                            "_ZN6geossl17cfconv_bwd_kernelILb1ELb0ELb1E"),
    "ncsn_score_fwd": ("ncsn_score", "_ZN6geossl15ncsn_fwd_kernel"),
    "ncsn_score_bwd": ("ncsn_score", "_ZN6geossl15ncsn_bwd_kernel"),
    # PaiNN's one-pass instances (R <= 31; ..._r64 below: the streamed ones)
    "painn_fwd": ("painn_fwd",
                  "_ZN6geossl20painn_fwd_mma_kernelILi3ELb0ELb0E"),
    "painn_fwd_sym": ("painn_fwd",
                      "_ZN6geossl20painn_fwd_mma_kernelILi3ELb1ELb0E"),
    "painn_bwd": ("painn_bwd", "_ZN6geossl20painn_bwd_mma_kernelILb0ELb0E"),
    "painn_bwd_sym": ("painn_bwd",
                      "_ZN6geossl20painn_bwd_mma_kernelILb1ELb0E"),
    # the stack: the instance its row's shape runs (stack_instance)
    "painn_stack": ("painn_stack", None),
    "painn_stack_train": ("painn_stack", None),
}
for _g in (100, 300):
    KERNEL_ENTRIES.update({
        f"cfconv_fwd_g{_g}": ("cfconv_fwd",
                              "_ZN6geossl17cfconv_fwd_kernelILb1ELb0E"),
        f"cfconv_fwd_sym_g{_g}": ("cfconv_fwd",
                                  "_ZN6geossl21cfconv_fwd_sym_kernelILb1ELb0E"),
        f"schnet_stack_g{_g}": ("schnet_stack",
                                "_ZN6geossl19schnet_stack_kernelILb1ELb1E"),
        f"cfconv_bwd_g{_g}": ("cfconv_bwd",
                              "_ZN6geossl17cfconv_bwd_kernelILb0ELb1ELb0E"),
        f"cfconv_bwd_sym_g{_g}": ("cfconv_bwd",
                                  "_ZN6geossl17cfconv_bwd_kernelILb1ELb1ELb0E")})


# phase 7's rows: the F = 128 instances (padded, or in column blocks), the
# head's kE = 256 instance
for _w in (256, 96):
    KERNEL_ENTRIES.update({
        f"{_k}_f{_w}": KERNEL_ENTRIES[_k]
        for _k in ("cfconv_fwd", "cfconv_fwd_sym", "cfconv_bwd",
                   "cfconv_bwd_sym", "schnet_stack")})
# phase 8's rows: PaiNN at F = 256 and 96 (the one-pass instances, in
# column blocks or padded) and at R = 64 (the streamed instances); the
# forward's and the stack's instances by their rows' R and shape, as the
# library chooses them (painn_fwd_instance, stack_instance)
for _tag, _stream in (("_f256", 0), ("_f96", 0), ("_r64", 1)):
    KERNEL_ENTRIES.update({
        f"painn_fwd{_tag}": ("painn_fwd", None),
        f"painn_fwd_sym{_tag}": ("painn_fwd", None),
        f"painn_bwd{_tag}": (
            "painn_bwd", f"_ZN6geossl20painn_bwd_mma_kernelILb0ELb{_stream}E"),
        f"painn_bwd_sym{_tag}": (
            "painn_bwd", f"_ZN6geossl20painn_bwd_mma_kernelILb1ELb{_stream}E"),
        f"painn_stack{_tag}": ("painn_stack", None)})
# phase 9's rows: the bf16 backwards' hidden-block instance at F = 256 and
# the head's streamed instance at E = 384 and 512
KERNEL_ENTRIES.update({
    "cfconv_bwd_bf16w_f256": (
        "cfconv_bwd_bf16w", "_ZN6geossl5bf16w23cfconv_bwd_bf16w_kernelILb0ELb0E"),
    "cfconv_bwd_sym_bf16w_f256": (
        "cfconv_bwd_bf16w", "_ZN6geossl5bf16w23cfconv_bwd_bf16w_kernelILb1ELb0E"),
    **{f"ncsn_score_{d}_wide_e{e}": (
        "ncsn_score_wide", f"_ZN6geossl5nwide20ncsn_wide_{d}_kernel")
       for d in ("fwd", "bwd") for e in (384, 512)}})
KERNEL_ENTRIES.update({
    "ncsn_score_fwd_e96": KERNEL_ENTRIES["ncsn_score_fwd"],
    "ncsn_score_bwd_e96": KERNEL_ENTRIES["ncsn_score_bwd"],
    "ncsn_score_fwd_e256": ("ncsn_score_e256", "_ZN6geossl15ncsn_fwd_kernel"),
    "ncsn_score_bwd_e256": ("ncsn_score_e256", "_ZN6geossl15ncsn_bwd_kernel")})


def stack_instance(b, n, res, num_r=20):
    """(rows per dense chunk, mangled-name prefix) of the painn_stack_kernel
    instance that a launch over b graphs of n atoms at ``num_r`` RBF rows
    runs on this card (the library's own choice: ``painn_stack_chunk_rows``,
    ``painn_stack_ks``; streamed above ``ops/painn.ONE_PASS_R``, which
    ``check_rbf_layout`` holds to the library), with ``res`` the residual
    mode."""
    import ctypes

    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import painn as P

    rows = _build.kernel_fn("painn_stack", "painn_stack_chunk_rows",
                            [ctypes.c_int] * 2)(b, n)
    ks = _build.kernel_fn("painn_stack", "painn_stack_ks",
                          [ctypes.c_int])(num_r)
    stream = int(num_r > P.ONE_PASS_R)
    return rows, (f"_ZN6geossl18painn_stack_kernelILb{int(res)}ELi{ks}"
                  f"ELi{rows}ELb{stream}E")


def painn_fwd_instance(sym, num_r):
    """Mangled-name prefix of the painn_fwd_mma_kernel instance that a
    launch at ``num_r`` RBF rows runs (the library's ``painn_fwd_ks``;
    streamed above ``ops/painn.ONE_PASS_R``), ``sym`` the mode."""
    import ctypes

    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import painn as P

    ks = _build.kernel_fn("painn_fwd", "painn_fwd_ks", [ctypes.c_int])(num_r)
    return (f"_ZN6geossl20painn_fwd_mma_kernelILi{ks}ELb{int(sym)}"
            f"ELb{int(num_r > P.ONE_PASS_R)}E")


def painn_passes(num_r):
    """Filter passes (kernel launches a call of the message-pass entries)
    at ``num_r`` RBF rows, as the library counts its chunks."""
    import ctypes

    from geossl_tpu_torch.ops import _build

    return _build.kernel_fn("painn_fwd", "painn_rbf_chunks",
                            [ctypes.c_int, ctypes.c_void_p])(num_r, None)


def check_rbf_layout(max_r=300):
    """Holds ``ops/painn.rbf_chunks`` (the copy the CPU tests exercise) and
    ``ONE_PASS_R`` to the library's ``painn_rbf_chunks`` (pair_tile.cuh's
    ``rbf_chunk``, which the kernels run) at every R from 2 to ``max_r``;
    fails on any difference."""
    import ctypes

    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import painn as P

    fn = _build.kernel_fn("painn_fwd", "painn_rbf_chunks",
                          [ctypes.c_int, ctypes.c_void_p])
    for r in range(P.MIN_R, max_r + 1):
        out = (ctypes.c_int * (3 * fn(r, None)))()
        n = fn(r, out)
        lib = [(out[3 * c], out[3 * c + 1], bool(out[3 * c + 2]))
               for c in range(n)]
        if lib != P.rbf_chunks(r) or (n > 1) != (r > P.ONE_PASS_R):
            fail(f"rbf layout at R={r}: the library's chunks {lib}, "
                 f"ops/painn's {P.rbf_chunks(r)} (ONE_PASS_R "
                 f"{P.ONE_PASS_R})")
    print(f"rbf layout: ops/painn.rbf_chunks and ONE_PASS_R agree with the "
          f"library's painn_rbf_chunks at R = {P.MIN_R}..{max_r}")


def stack_ptxas(b, n, res, num_r=20):
    """{"chunk_rows", "ptxas"} of the instance stack_instance names."""
    from geossl_tpu_torch.ops import _build

    rows, entry = stack_instance(b, n, res, num_r)
    return {"chunk_rows": rows,
            "ptxas": ptxas_usage(_build.build_log("painn_stack"), entry)}


def ptxas_usage(log, prefix):
    """{"registers", "spill_store_bytes", "spill_load_bytes"} of the entry
    function named ``prefix...`` in ``nvcc -Xptxas -v`` output (None where
    the log does not say)."""
    import re

    usage = {"registers": None, "spill_store_bytes": None,
             "spill_load_bytes": None}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or not current.startswith(prefix):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage["spill_store_bytes"] = int(m.group(1))
            usage["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage["registers"] = int(m.group(1))
    return usage


def chunked(fn, batched, rest, chunk):
    """fn over slices of the batch dimension (the plain versions materialize
    [B,N,N,F]; per-graph results are independent)."""
    import torch

    b = batched[0].shape[0]
    return torch.cat([fn(*(t[s:s + chunk] for t in batched), *rest)
                      for s in range(0, b, chunk)])


def chunked_sum(fn, batched, rest, chunk, n_cat):
    """fn over slices of the batch dimension for a function whose first
    ``n_cat`` outputs are per graph (concatenated) and the others sums over
    the batch (added up): the plain backward versions."""
    import torch

    b = batched[0].shape[0]
    parts = [fn(*(t[s:s + chunk] for t in batched), *rest)
             for s in range(0, b, chunk)]
    return tuple(torch.cat(col) if k < n_cat else sum(col)
                 for k, col in enumerate(zip(*parts)))


def tile_occupied(env, tile=8):
    """[B,N,N] bool: the cell lies in an 8x8 tile with a nonzero env."""
    import torch.nn.functional as F

    b, n, m = env.shape
    nz = F.pad((env != 0).float(), (0, -m % tile, 0, -n % tile))
    occ = nz.view(b, nz.shape[1] // tile, tile, nz.shape[2] // tile, tile)
    occ = occ.amax(dim=(2, 4)) > 0
    return occ.repeat_interleave(tile, 1).repeat_interleave(tile, 2)[:, :n, :m]


class Errors:
    """Largest |kernel - plain| seen per kernel, failing on a mismatch."""

    def __init__(self):
        self.max_abs = {}

    def _note(self, name, got, want, what):
        import torch

        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name} {what}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)} or non-finite output")
        err = (got - want).abs().max().item()
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), err)
        return err

    def check_scaled(self, name, got, want, what):
        """Elementwise, rtol RTOL and atol ATOL times max|want| (sums over
        up to N terms)."""
        err = self._note(name, got, want, what)
        atol = ATOL * max(1.0, want.abs().max().item())
        if not (got - want).abs().le(atol + RTOL * want.abs()).all():
            fail(f"{name} {what}: max_abs_err {err:.3e} beyond rtol {RTOL} "
                 f"atol {atol:.3e}")
        print(f"parity {name} {what}: max_abs_err {err:.3e} (atol {atol:.2e})")

    def check_norm(self, name, got, want, what, tol=GRAD_RTOL):
        """Relative Frobenius norm (sums over many pairs that cancel)."""
        err = self._note(name, got, want, what)
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        if rel > tol:
            fail(f"{name} {what}: relative error {rel:.3e} beyond {tol}")
        print(f"parity {name} {what}: rel_norm {rel:.3e} max_abs_err {err:.3e}")

    def check(self, name, got, want, what):
        import torch

        err = self._note(name, got, want, what)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"{name} {what}: max_abs_err {err:.3e} beyond rtol {RTOL} "
                 f"atol {ATOL}")
        print(f"parity {name} {what}: max_abs_err {err:.3e}")


BWD_NAMES = ("ddist", "denv", "dx", "dW1", "db1", "dW2", "db2")


def check_weight_grads(errs, kernel, got, want, names, what):
    """A kernel's weight gradients: all together by relative norm
    GRAD_RTOL, each by 10x that (a scalar bias such as db_d2 sums ~1e6
    pair terms that cancel to a few parts in 1e3 of their scale)."""
    import torch

    for name, a, w in zip(names, got, want):
        errs.check_norm(kernel, a, w, f"{what} {name}", tol=10 * GRAD_RTOL)
    errs.check_norm(kernel, torch.cat([a.flatten() for a in got]),
                    torch.cat([w.flatten() for w in want]),
                    f"{what} all weight gradients")


def check_cfconv_bwd(errs, dist, env, x, g, fw, G, cutoff, what, chunk=None,
                     name="cfconv_bwd"):
    """cfconv_bwd against its plain version, gating off and on (recorded
    under ``name``); returns the kernel's outputs with gating on."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K

    args = (0.0, cutoff, G)
    if chunk is None:
        want = K.cfconv_bwd_reference(dist, env, x, g, *fw, *args)
    else:
        want = chunked_sum(K.cfconv_bwd_reference, (dist, env, x, g),
                           (*fw, *args), chunk, 3)
    occ = tile_occupied(env)
    for sp in (False, True):
        got = K.cfconv_bwd(dist, env, x, g, *fw, *args, sp)
        for k, (out, a, w) in enumerate(zip(BWD_NAMES, got, want)):
            tag = f"{what} sparse={sp} {out}"
            if out == "denv" and sp:
                if (a[~occ] != 0).any():
                    fail(f"{name} {tag}: nonzero on an empty tile")
                w = torch.where(occ, w, torch.zeros_like(w))
            if k < 3:
                errs.check_scaled(name, a, w, tag)
        check_weight_grads(errs, name, got[3:], want[3:], BWD_NAMES[3:],
                           f"{what} sparse={sp}")
    return got


def check_cfconv_bwd_sym(errs, dist, env, x, g, fw, G, cutoff, what,
                         chunk=None, name="cfconv_bwd_sym"):
    """cfconv_bwd_sym against its plain version, gating off and on: ddist
    and denv by the placement contract (``ops/cfconv.place_sym_cotangent``
    of the plain, unplaced cotangents; with gating also zero on empty 8x8
    tiles), elementwise with the scaled atol; dx elementwise; the weight
    gradients by relative norm (recorded under ``name``). Returns the
    kernel's outputs with gating on."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K

    args = (0.0, cutoff, G)
    if chunk is None:
        want = K.cfconv_bwd_sym_reference(dist, env, x, g, *fw, *args)
    else:
        want = chunked_sum(K.cfconv_bwd_sym_reference, (dist, env, x, g),
                           (*fw, *args), chunk, 3)
    want = (*(K.place_sym_cotangent(w) for w in want[:2]), *want[2:])
    occ = tile_occupied(env)
    for sp in (False, True):
        got = K.cfconv_bwd_sym(dist, env, x, g, *fw, *args, sp)
        for k, (out, a, w) in enumerate(zip(BWD_NAMES[:3], got, want)):
            tag = f"{what} sparse={sp} {out}"
            if k < 2 and sp:
                if (a[~occ] != 0).any():
                    fail(f"{name} {tag}: nonzero on an empty tile")
                w = torch.where(occ, w, torch.zeros_like(w))
            errs.check_scaled(name, a, w, tag)
        check_weight_grads(errs, name, got[3:], want[3:], BWD_NAMES[3:],
                           f"{what} sparse={sp}")
    return got


PAINN_BWD_NAMES = ("ddist", "dgate", "ddirx", "ddiry", "ddirz", "dx", "dmu",
                   "dWk", "dbk")


def painn_inputs(m, batch, seed=SEED, pair_mask=None):
    """PaiNN's message-pass inputs on a packed batch: the five pair grids
    (dist, gate, dir x/y/z), q0, block 0's x and a seeded mu of unit scale
    (block 0's own mu is zero, which would test nothing)."""
    import torch

    with torch.no_grad():
        dist, direction, gate = m.geometry(batch.positions, batch.node_mask,
                                           pair_mask)
        q0 = m.embed(batch.atom_type).contiguous()
        x = m.interactions[0].interatomic_context_net(q0).contiguous()
    gen = torch.Generator(x.device).manual_seed(seed)
    mu = torch.randn(x.shape, generator=gen, device=x.device)
    grids = (dist.contiguous(), gate.contiguous(),
             *(direction[..., c].contiguous() for c in range(3)))
    return grids, q0, x, mu


def check_painn_bwd(errs, grids, x, mu, wk, bk, gq, gmu, cutoff, what,
                    chunk=None, symmetric=False, want=None, tag=""):
    """painn_bwd (with ``symmetric``, painn_bwd_sym) against its plain
    version, gating off and on: the seven per-pair and per-node cotangents
    elementwise (scaled), dWk and dbk by relative norm; with gating, the
    five pair cotangents must be zero on empty 8x8 tiles (dgate is compared
    on the occupied ones). painn_bwd_sym's pair cotangents are held to the
    plain ones placed (``ops/cfconv.place_sym_cotangent``: ddist and dgate
    symmetric, the three ddir antisymmetric). ``want``: the plain version's
    output on these inputs, if made already. Checks are recorded as
    ``<kernel><tag>``. Returns it."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import painn as P

    def plain(d, g, a, b, c, xx, m, gq_, gmu_):
        return P.painn_bwd_reference(d, g, a, b, c, xx, m, wk, bk, gq_, gmu_,
                                     cutoff)

    if want is None:
        want = (plain(*grids, x, mu, gq, gmu) if chunk is None else
                chunked_sum(plain, (*grids, x, mu, gq, gmu), (), chunk, 7))
    name_k, bwd, ref = "painn_bwd" + tag, P.painn_bwd, want
    if symmetric:
        name_k, bwd = "painn_bwd_sym" + tag, P.painn_bwd_sym
        ref = (*(K.place_sym_cotangent(w, antisymmetric=k >= 2)
                 for k, w in enumerate(want[:5])), *want[5:])
    occ = tile_occupied(grids[1])
    for sp in (False, True):
        got = bwd(*grids, x, mu, wk, bk, gq, gmu, cutoff, sp)
        for k, (name, a, w) in enumerate(zip(PAINN_BWD_NAMES[:7], got, ref)):
            tag = f"{what} sparse={sp} {name}"
            if k < 5 and sp:
                if (a[~occ] != 0).any():
                    fail(f"{name_k} {tag}: nonzero on an empty tile")
                w = torch.where(occ, w, torch.zeros_like(w))
            errs.check_scaled(name_k, a, w, tag)
        check_weight_grads(errs, name_k, got[7:], ref[7:],
                           PAINN_BWD_NAMES[7:], f"{what} sparse={sp}")
    return want


def check_painn_sym(errs, grids, x, mu, wk, bk, gq, gmu, cutoff, what,
                    want_fwd=None, want_bwd=None, tag=""):
    """The symmetric PaiNN pair on symmetric grids against its plain
    versions, gating off and on (``painn_fwd_sym`` elementwise,
    ``painn_bwd_sym`` through ``check_painn_bwd``), then a second launch of
    each against the first: the five pair cotangents and dWk/dbk bitwise,
    the rows summed with atomics (dq, dmu; dx, dmu) within the tolerances.
    ``want_fwd`` / ``want_bwd``: the plain versions' outputs, if made.
    Checks are recorded as ``<kernel><tag>``."""
    import torch

    from geossl_tpu_torch.ops import painn as P

    with torch.no_grad():
        if want_fwd is None:
            want_fwd = chunked(lambda *a: torch.cat(P.painn_message_reference(
                *a, wk, bk, cutoff), dim=-1), (*grids, x, mu), (), 4)
        for sp in (False, True):
            got = torch.cat(P.painn_message_fused_sym(
                *grids, x, mu, wk, bk, cutoff, sp), dim=-1)
            errs.check("painn_fwd_sym" + tag, got, want_fwd,
                       f"{what} sparse={sp}")
            errs.check("painn_fwd_sym" + tag, torch.cat(P.painn_message_fused_sym(
                *grids, x, mu, wk, bk, cutoff, sp), dim=-1), got,
                f"{what} sparse={sp} second launch")
    check_painn_bwd(errs, grids, x, mu, wk, bk, gq, gmu, cutoff, what,
                    chunk=8, symmetric=True, want=want_bwd, tag=tag)
    one, two = (P.painn_bwd_sym(*grids, x, mu, wk, bk, gq, gmu, cutoff, True)
                for _ in range(2))
    for k, (name, a, b) in enumerate(zip(PAINN_BWD_NAMES, one, two)):
        if k in (5, 6):
            errs.check_scaled("painn_bwd_sym" + tag, b, a, f"{what} {name} "
                              "second launch")
        elif not torch.equal(a, b):
            fail(f"painn_bwd_sym{tag} {what}: {name} differs between two "
                 "launches")
    print(f"painn_bwd_sym {what}: pair cotangents and weight gradients "
          "repeat bitwise")


def measure_serving(pred, subs, model_3d):
    """Serving mol/s per bucket (median of 3 synchronized passes after a
    warm-up) and one traced pass per bucket."""
    device_profile(lambda: pred.predict(next(iter(subs.values()))))  # start-up
    for b, sub in subs.items():
        pred.predict(sub)  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(sub)  # ends in a device-to-host copy: synchronized
            times.append(time.perf_counter() - t0)
        t = sorted(times)[1]
        print("serve: " + json.dumps({"model": model_3d, "bucket": b,
                                      "molecules": len(sub),
                                      "batches": -(-len(sub) // 128),
                                      "s_per_pass": t,
                                      "mol_per_s": len(sub) / t}))
        # a separate traced pass (the profiler slows the host side)
        wall, busy, ours = device_profile(lambda: pred.predict(sub))
        print("profile: " + json.dumps({
            "model": model_3d, "bucket": b, "traced_wall_s": wall,
            "device_busy_s": busy, "port_kernels_s": ours,
            "other_device_s": busy - ours, "idle_share": 1.0 - busy / wall}))
    print_top_ops(lambda: pred.predict(sub), model_3d, "serve", b)


def measure_serving_route(pred, batches, model_3d, stack_kernel):
    """The Predictor's two routes head to head per bucket, on the bucket's
    first batch of 128 slots: the whole representation (embedding to pooled
    output) through the whole-stack kernel and through the per-block
    kernels, CUDA-event timed, three rounds in turns (median and range of
    the rounds). ``routed`` reads the Predictor's own pick (launch counters
    around ``_graph_repr``); ``ok`` says that it is the faster route or that
    the two ranges overlap."""
    import torch

    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts

    out = {}
    for b, batch in batches.items():
        args = (batch.atom_type, batch.positions, batch.node_mask)
        filters, stacked = pred._prep
        fns = {"stack": lambda: pred._stack_apply(pred.model, *args,
                                                  stacked=stacked),
               "per_block": lambda: pred.model(*args, filters=filters)}
        times = {k: [] for k in fns}
        with torch.inference_mode():
            for _ in range(3):
                for k, fn in fns.items():
                    times[k].append(cuda_time_ms(fn, reps=5, warmup=1))
            reset_launch_counts()
            pred._graph_repr(pred._prep, *args)
            torch.cuda.synchronize()
        routed = "stack" if launch_counts()[stack_kernel] else "per_block"
        med = {k: sorted(v)[1] for k, v in times.items()}
        faster = min(med, key=med.get)
        other = "stack" if routed == "per_block" else "per_block"
        overlap = min(times[routed]) <= max(times[other])
        out[b] = {"ms": med, "range_ms": {k: [min(v), max(v)]
                                          for k, v in times.items()},
                  "faster": faster, "routed": routed,
                  "ok": routed == faster or overlap}
    print("serving_route: " + json.dumps({"model": model_3d,
                                          "buckets": out}))


def measure_training(ddm, targs, batches, model_3d):
    """Training mol/s per bucket (median of 3 synchronized steps after a
    warm-up) and one traced step per bucket."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(), 100)
    gen_t = torch.Generator(batches[0].positions.device).manual_seed(SEED)
    device_profile(lambda: PG.train_step(ddm, opt, sched, [batches[0]],
                                         targs, gen_t))  # profiler start-up
    for batch in batches:
        b = batch.max_atoms
        mols = int(batch.graph_mask.sum())

        def step():
            return PG.train_step(ddm, opt, sched, [batch], targs, gen_t)

        step()  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t = sorted(times)[1]
        print("train: " + json.dumps({"model": model_3d, "bucket": b,
                                      "molecules": mols, "s_per_step": t,
                                      "mol_per_s": mols / t}))
        wall, busy, ours = device_profile(step)
        print("train_profile: " + json.dumps({
            "model": model_3d, "bucket": b, "traced_wall_s": wall,
            "device_busy_s": busy, "port_kernels_s": ours,
            "other_device_s": busy - ours, "idle_share": 1.0 - busy / wall}))
    print_top_ops(step, model_3d, "train", b)


def measure_stack_training(ddm, targs, batches):
    """DDM-PaiNN mol/s per bucket through the differentiable whole stack
    and through the per-block kernels (``train_step``), each the median of 3
    synchronized optimizer steps after a warm-up, in turns."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(), 100)
    gen_t = torch.Generator(batches[0].positions.device).manual_seed(SEED)

    def stack_step(batch):
        opt.zero_grad(set_to_none=True)
        pos2, sel = PG.batch_views(targs, batch, gen_t)
        loss = ddm_stack_loss(ddm, batch, pos2, sel, generator=gen_t)
        loss.backward()
        opt.step()
        sched.step()

    def block_step(batch):
        PG.train_step(ddm, opt, sched, [batch], targs, gen_t)

    steps = {"stack": stack_step, "per_block": block_step}
    for batch in batches:
        mols = int(batch.graph_mask.sum())
        times = {name: [] for name in steps}
        for step in steps.values():
            step(batch)  # warm-up
        for _ in range(3):
            for name, step in steps.items():
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        med = {k: sorted(v)[1] for k, v in times.items()}
        print("train_stack: " + json.dumps({
            "model": "painn", "bucket": batch.max_atoms, "molecules": mols,
            "s_per_step": med, "mol_per_s": {k: mols / v for k, v in
                                            med.items()}}))


def measure_finetune(net, fargs, batch, loss_fn, task, items):
    """Fine-tune throughput at N=512 (median of 3 synchronized optimizer
    steps after a warm-up: ``items`` complexes, or LEP pairs, per step),
    one traced step, and the step's top device kernels."""
    import torch

    from geossl_tpu_torch.train import common

    opt, sched = common.make_optimizer_from_args(fargs, net.parameters(), 100)

    def step():
        return common.finetune_step(net, opt, sched, [batch], loss_fn)

    device_profile(step)  # profiler start-up
    step()  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = sorted(times)[1]
    model_3d = fargs.model_3d
    print("finetune: " + json.dumps({"task": task, "model": model_3d,
                                     "bucket": batch.max_atoms,
                                     "items": items, "s_per_step": t,
                                     "items_per_s": items / t}))
    wall, busy, ours = device_profile(step)
    print("finetune_profile: " + json.dumps({
        "task": task, "model": model_3d, "bucket": batch.max_atoms,
        "traced_wall_s": wall, "device_busy_s": busy, "port_kernels_s": ours,
        "other_device_s": busy - ours, "idle_share": 1.0 - busy / wall}))
    print_top_ops(step, model_3d, f"finetune_{task}", batch.max_atoms)


def ncsn_inputs(ddm, batch, targs, seed):
    """The head's kernel inputs on this batch as the training step makes
    them: (dist of the perturbed view, noise, sel, sigma, u), the ten
    weights and the anneal power."""
    import torch

    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.train.pretrain_geossl import batch_views

    gen = torch.Generator(batch.positions.device).manual_seed(seed)
    pos2, sel = batch_views(targs, batch, gen)
    head = ddm.NCSN_01
    with torch.no_grad():
        _, h1 = ddm.model(batch.atom_type, batch.positions, batch.node_mask)
        u = head.out0_h(h1).contiguous()
    d2, _ = geometry.pairwise_distances(pos2, batch.node_mask)
    b = d2.shape[0]
    level = torch.randint(0, head.num_noise_level, (b,), generator=gen,
                          device=d2.device)
    noise = torch.randn(d2.shape, generator=gen, device=d2.device)
    weights = [w.detach() for w in head.head_weights()]
    return ((d2.contiguous(), noise, sel.float(), head.sigmas[level], u),
            weights, head.anneal_power)


def check_ncsn(errs, grid, weights, anneal, what, chunk=None, tag=""):
    """ncsn_score_fwd/_bwd against their plain versions (recorded as
    ``ncsn_score_fwd<tag>`` / ``ncsn_score_bwd<tag>``)."""
    import torch

    from geossl_tpu_torch.ops import ncsn as NS

    gen = torch.Generator(grid[0].device).manual_seed(SEED)
    g_rows = torch.randn(grid[0].shape[:2], generator=gen,
                         device=grid[0].device)
    with torch.no_grad():
        if chunk is None:
            want_rows = NS.ncsn_score_loss_reference(*grid, *weights, anneal)
            want = NS.ncsn_score_bwd_reference(*grid, g_rows, *weights,
                                               anneal=anneal)
        else:
            want_rows = chunked(NS.ncsn_score_loss_reference, grid,
                                (*weights, anneal), chunk)
            want = chunked_sum(
                lambda *a: NS.ncsn_score_bwd_reference(*a, anneal=anneal),
                (*grid, g_rows), weights, chunk, 1)
    errs.check_scaled("ncsn_score_fwd" + tag, NS.ncsn_score_fwd(
        *grid, *weights, anneal=anneal), want_rows, f"{what} rows")
    got = NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal)
    # du by norm too: relu' flips where a pre-activation lies within
    # rounding of zero, and at the DDM shape (~65M relu decisions per call)
    # a few always do, each moving some du elements by a whole term
    errs.check_norm("ncsn_score_bwd" + tag, got[0], want[0], f"{what} du")
    check_weight_grads(errs, "ncsn_score_bwd" + tag, got[1:], want[1:],
                       ["d" + n for n in NS.WEIGHT_NAMES], what)
    return g_rows


def sub_batch(batch, sl):
    from dataclasses import fields, replace

    return replace(batch, **{f.name: getattr(batch, f.name)[sl]
                             for f in fields(batch)
                             if getattr(batch, f.name) is not None})


def grads_in_chunks(module, batch, loss_of, chunk=None):
    """(loss, {name: gradient}) of one step whose loss is a mean over the
    real graphs; ``loss_of(sub_batch, sl)`` is the loss of the graphs in
    slice ``sl``. ``chunk`` splits the batch into graph chunks weighted by
    their share of the real graphs, for the plain versions' memory."""
    module.zero_grad(set_to_none=True)
    gm = batch.graph_mask
    b = gm.shape[0]
    chunk = chunk or b
    count = max(int(gm.sum()), 1)
    total = 0.0
    for s in range(0, b, chunk):
        sl = slice(s, s + chunk)
        c = int(gm[sl].sum())
        if c == 0:
            continue
        loss = loss_of(sub_batch(batch, sl), sl) * (c / count)
        loss.backward()
        total += loss.item()
    return total, {n: p.grad.detach().clone()
                   for n, p in module.named_parameters()}


def ddm_grads(ddm, batch, pos2, sel, draws, chunk=None):
    """``grads_in_chunks`` of one DDM step with injected noise."""
    return grads_in_chunks(
        ddm, batch, lambda sb, sl: ddm(sb, pos2[sl], sel[sl],
                                       tuple(t[sl] for t in draws)), chunk)


def check_step_parity(what, loss_k, grads_k, loss_p, grads_p, zero_grad=()):
    """A step with kernels against the same step with the plain versions:
    loss rtol RTOL, all gradients together by relative norm GRAD_RTOL and
    each parameter's by 10x that. ``zero_grad`` names parameters whose
    gradient is zero in exact arithmetic (both sides compute rounding
    noise, whose relative difference means nothing): each side's norm must
    stay below ZERO_GRAD_RTOL of the whole gradient's instead."""
    import torch

    if not abs(loss_k - loss_p) <= RTOL * abs(loss_p):
        fail(f"{what}: loss {loss_k} (kernels) vs {loss_p} (plain)")

    whole = torch.cat([g.flatten() for g in grads_p.values()]).norm().item()
    for n in zero_grad:
        size = max(grads_k[n].norm().item(), grads_p[n].norm().item()) / whole
        if size > ZERO_GRAD_RTOL:
            fail(f"{what}: {n}, zero in exact arithmetic, has a gradient of "
                 f"{size:.3e} of the whole's norm")
        print(f"{what}: {n} (zero in exact arithmetic): gradient norm "
              f"{size:.3e} of the whole's")
    per = {n: rel_norm(grads_k[n], grads_p[n]) for n in grads_p
           if n not in zero_grad}
    worst = max(per, key=per.get)
    total = rel_norm(torch.cat([g.flatten() for g in grads_k.values()]),
                     torch.cat([g.flatten() for g in grads_p.values()]))
    if total > GRAD_RTOL or per[worst] > 10 * GRAD_RTOL:
        fail(f"{what}: gradients differ by relative norm {total:.3e} in all, "
             f"{per[worst]:.3e} in {worst}")
    print(f"{what}: loss {loss_k:.6f} vs {loss_p:.6f}, gradient rel_norm "
          f"{total:.3e} in all {len(per)} tensors, worst {per[worst]:.3e} "
          f"({worst})")


def step_parity(ddm, batch, targs, bucket, model_3d="SchNet"):
    """One full-width DDM step with kernels against the plain versions on
    the card, with the same injected noise."""
    pos2, sel, draws = step_draws(ddm, batch, targs, bucket)
    loss_k, grads_k = ddm_grads(ddm, batch, pos2, sel, draws)
    ddm.plain = True
    loss_p, grads_p = ddm_grads(ddm, batch, pos2, sel, draws, chunk=16)
    ddm.plain = False
    check_step_parity(f"{model_3d} step parity bucket {bucket}", loss_k,
                      grads_k, loss_p, grads_p)


def ddm_stack_loss(ddm, batch, pos2, sel, draws=None, generator=None):
    """The DDM loss of ``DDM.forward`` with both views through the
    differentiable whole stack (``models/painn.stack_train_apply``) and the
    clean geometry's radius graph as their pair mask, as the JAX package's
    ``experiments/kexp10.py`` builds it; the same NCSN heads."""
    from geossl_tpu_torch.models.painn import stack_train_apply
    from geossl_tpu_torch.ops import geometry

    z, mask, m = batch.atom_type, batch.node_mask, ddm.model
    d1, pm = geometry.pairwise_distances(batch.positions, mask)
    pair_mask = geometry.radius_adjacency(d1, pm, m.cutoff, m.max_neighbors)
    _, h1 = stack_train_apply(m, z, batch.positions, mask, pair_mask)
    _, h2 = stack_train_apply(m, z, pos2, mask, pair_mask)
    d2, _ = geometry.pairwise_distances(pos2, mask)
    s1, n1, s2, n2 = draws if draws is not None else (None,) * 4
    l1 = ddm.NCSN_01(h1, d2, sel, batch.graph_mask, s1, n1, generator)
    l2 = ddm.NCSN_02(h2, d1, sel, batch.graph_mask, s2, n2, generator)
    return (l1 + l2) / 2


def step_draws(ddm, batch, targs, bucket):
    """(pos2, sel, draws) of one DDM step, seeded by the bucket: the views
    and each head's noise levels and noise."""
    import torch

    from geossl_tpu_torch.train.pretrain_geossl import batch_views

    gen = torch.Generator(batch.positions.device).manual_seed(SEED + bucket)
    pos2, sel = batch_views(targs, batch, gen)
    draws = []
    for head in (ddm.NCSN_01, ddm.NCSN_02):
        level = torch.randint(0, head.num_noise_level, (batch.batch_size,),
                              generator=gen, device=sel.device)
        draws += [head.sigmas[level],
                  torch.randn(sel.shape, generator=gen, device=sel.device)]
    return pos2, sel, draws


# The QM9 fine-tune at the published protocol (scripts/finetune_qm9.sh:
# batch 128, lr 5e-4 cosine, MAE loss; task mu; buckets 32/64/128), cut to
# 4,096 synthetic molecules (QM9 has 130,831) and 1 epoch (1000 published)
QM9_FLAGS = ["--synthetic", "--synthetic_size", "4096", "--epochs", "1",
             "--batch_size", "128", "--lr", "5e-4", "--loss", "mae",
             "--task", "mu"]


def is_cos_kernel(name):
    """torch's elementwise cos kernel (SchNet's envelope), not acos/cosh."""
    return "cos_kernel" in name and "acos" not in name and "cosh" not in name


def qm9_path(dev, model_3d, pretrained, kernels, stack_kernel):
    """Phase 3e for one backbone: ``finetune_qm9.main`` for one epoch from
    the DDM ``model.pth`` (launch counts, finite losses and MAEs), its best
    ``model.pth`` served by a ``Predictor`` (through ``stack_kernel``) to
    the driver's ``evaluation_best.npz`` test predictions, one step with
    kernels held to the plain step on a freshly seeded net, and the
    ``qm9:`` line (and, for SchNet, the ``top_ops:`` line with the
    envelope's cos). Returns the path's launch counts."""
    import math

    import numpy as np
    import torch

    from geossl_tpu_torch.data.bucketing import BucketedLoader, assign_buckets
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import finetune_qm9 as FQ

    run_dir = os.path.join(ROOT, "runs", f"chip_smoke_qm9_{model_3d}")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = QM9_FLAGS + ["--model_3d", model_3d, "--input_model_file",
                        pretrained, "--output_model_dir", run_dir,
                        "--device", str(dev)]
    reset_launch_counts()
    t0 = time.time()
    _, best, test_mae, losses = FQ.main(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"main path (qm9 fine-tune, {model_3d}): {len(losses)} steps and "
          f"one val/test pass in {time.time() - t0:.2f} s (first call); "
          f"launches {counts}")
    for name in kernels:
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the QM9 {model_3d} path")
    if not losses or not all(math.isfinite(v) for v in losses) or \
            not math.isfinite(best) or not math.isfinite(test_mae):
        fail(f"qm9 {model_3d}: losses {losses}, best val MAE {best}, test "
             f"MAE {test_mae}")
    print(f"qm9 {model_3d} losses: {losses}; best val MAE {best}; test MAE "
          f"{test_mae}")

    # the best model.pth served: the stack route at bucket 32, held to the
    # driver's own test predictions (the per-block kernels made those);
    # atol scaled by y_std, which multiplies the head's output
    args = FQ.build_parser().parse_args(argv)
    cfg = common.model_config_from_args(args)
    buckets = common.buckets(args)
    splits, mean, std = FQ.load_splits(args)
    test = splits[2]
    ev = np.load(os.path.join(run_dir, "evaluation_best.npz"))
    bucket_of = assign_buckets(test.num_atoms(), buckets)
    order = np.concatenate([np.nonzero(bucket_of == b)[0]
                            for b in np.unique(bucket_of)])
    pred = Predictor.from_checkpoint(os.path.join(run_dir, "model.pth"), cfg,
                                     batch_size=args.batch_size,
                                     bucket_sizes=buckets, device=dev)
    reset_launch_counts()
    served = pred.predict(test)[order]
    torch.cuda.synchronize()
    if launch_counts()[stack_kernel] == 0:
        fail(f"qm9 {model_3d}: serving model.pth did not launch {stack_kernel}")
    want = ev["test_pred"]
    err = float(np.abs(served - want).max())
    if served.shape != want.shape or \
            not np.allclose(served, want, rtol=RTOL, atol=ATOL * std):
        fail(f"qm9 {model_3d}: served test predictions vs the driver's, "
             f"max_abs_err {err:.3e} (rtol {RTOL}, atol {ATOL * std:.2e})")
    print(f"qm9 {model_3d}: model.pth served through {stack_kernel} to the "
          f"driver's {len(want)} test predictions, max_abs_err {err:.3e} "
          f"(rtol {RTOL}, atol {ATOL * std:.2e})")

    # one step with kernels against the plain step, on a freshly seeded net
    # and the first training batch (bucket 32, 128 molecules)
    net = FQ.make_net(args, cfg, torch.Generator().manual_seed(SEED)).to(dev)
    loss_fn = FQ.make_loss_fn(args.loss, mean, std)
    train = BucketedLoader(splits[0], args.batch_size, buckets, seed=SEED)
    batch = next(iter(train.epoch(1))).to(dev)
    loss_k, grads_k = grads_in_chunks(net, batch,
                                      lambda sb, sl: loss_fn(net, sb))
    net.plain = True
    loss_p, grads_p = grads_in_chunks(net, batch,
                                      lambda sb, sl: loss_fn(net, sb), chunk=32)
    net.plain = False
    check_step_parity(f"QM9-{model_3d} step parity bucket "
                      f"{batch.max_atoms}", loss_k, grads_k, loss_p, grads_p)

    # throughput: optimizer steps and eval passes, untraced (median of 3
    # after a warm-up), then one traced step
    opt, sched = common.make_optimizer_from_args(args, net.parameters(), 100)
    mols = int(batch.graph_mask.sum())

    def step():
        return common.finetune_step(net, opt, sched, [batch], loss_fn)

    evaluate = FQ.Evaluator(dev, mean, std)
    val_loader = BucketedLoader(splits[1], args.batch_size, buckets,
                                shuffle=False)

    device_profile(step)  # profiler start-up
    train_s, eval_s = median_s(step), median_s(lambda: evaluate(net, val_loader))
    wall, busy, ours = device_profile(step)
    print("qm9: " + json.dumps({
        "model": model_3d, "bucket": batch.max_atoms, "molecules": mols,
        "epoch_steps": len(losses), "s_per_step": train_s,
        "train_mol_per_s": mols / train_s, "eval_molecules": len(splits[1]),
        "eval_mol_per_s": len(splits[1]) / eval_s,
        "device_ms_per_step": busy * 1e3, "port_kernels_ms": ours * 1e3,
        "other_device_ms": (busy - ours) * 1e3, "traced_wall_ms": wall * 1e3,
        "idle_share": 1.0 - busy / wall}))
    if model_3d == "schnet":
        cos = print_top_ops(step, model_3d, "finetune_qm9", batch.max_atoms,
                            also=is_cos_kernel)
        calls = sum(count for _, _, count in cos)
        if calls != 1:
            fail(f"qm9 schnet: the step's forward launched {calls} cos "
                 "kernels (the envelope is made once per forward)")
        print("qm9 schnet: one cos kernel per forward (the envelope)")
    return counts


def median_s(fn):
    """Median of 3 synchronized calls of fn after a warm-up, seconds."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


# MD17 at the published protocol (scripts/finetune/
# submit_finetune_md17_schnet.sh: train batch 5, eval batch 128, lr 5e-4,
# loss 0.05 L1(E) + 0.95 L1(F); task aspirin), cut to 2,400 synthetic frames
# of aspirin's 21 atoms (split 1000/1000/400; aspirin has 211,762 frames)
# and 1 epoch (1000 published), at bucket 32
MD17_FLAGS = ["--synthetic", "--synthetic_size", "2400", "--epochs", "1",
              "--task", "aspirin", "--bucket", "32"]


def plain_forces(pred, store, chunk=128):
    """(energies [M], forces [sum_N, 3]) of the Predictor's weights through
    the plain versions (``model.forward(plain=True)`` and autograd), chunk
    by chunk in store order; every molecule has its bucket's atoms or
    fewer."""
    import torch

    from geossl_tpu_torch.data.bucketing import pack_batch
    from geossl_tpu_torch.train import finetune_md17 as FM
    from geossl_tpu_torch.train.finetune_lba import LBANet

    net = LBANet(pred.model, pred.head, plain=True)
    es, fs = [], []
    for s in range(0, len(store), chunk):
        recs = [store.get(i) for i in range(s, min(s + chunk, len(store)))]
        batch = pack_batch(recs, pred.bucket_sizes[0]).to(pred.device)
        e, f = FM.energy_and_force(net, batch)
        # the Predictor's forces are those of its denormalized energy
        es.append(e.detach() * pred.y_std + pred.y_mean)
        fs.append(f[batch.node_mask] * pred.y_std)
    return torch.cat(es), torch.cat(fs)


def check_forces(what, got, want):
    """predict_forces against the plain path: rtol RTOL, atol ATOL times
    the largest |want| (forces sum over every block's pair terms)."""
    import torch

    got = torch.as_tensor(got, device=want.device)
    err = (got - want).abs().max().item()
    atol = ATOL * want.abs().max().item()
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            not (got - want).abs().le(atol + RTOL * want.abs()).all():
        fail(f"{what}: max_abs_err {err:.3e} beyond rtol {RTOL} atol "
             f"{atol:.3e} (shapes {tuple(got.shape)}, {tuple(want.shape)})")
    print(f"{what}: max_abs_err {err:.3e} (rtol {RTOL}, atol {atol:.3e})")


def second_order_chain(op, pair_of, pos, mask, ins):
    """Gradients to the positions and ``ins`` of a force loss through
    ``op(*pair_of(pos, mask), *ins)``: E = sum tanh(messages), F =
    -dE/dpos with a graph, loss = E + sum F^2 (the MD17 step's double
    backward through one op)."""
    import torch

    pos = pos.detach().clone().requires_grad_(True)
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    out = op(*pair_of(pos, mask), *ins)
    out = torch.cat(out, -1) if isinstance(out, tuple) else out
    e = torch.tanh(out).sum()
    (grad,) = torch.autograd.grad(e, pos, create_graph=True)
    loss = e + (grad * grad).sum()
    return torch.autograd.grad(loss, [pos] + ins)


def check_second_orders(batch, net_s, net_p):
    """The four second orders (#2, #4, #9, #11's: autograd over the plain
    backward) on the card at MD17's training shape, block 0's inputs of
    each backbone: the force loss's gradients through each kernel Function
    against autograd through the plain chain, each tensor elementwise at
    rtol RTOL and atol ATOL times its largest magnitude."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts

    m = net_s.model
    blk = m.interactions[0]
    g, cut = m.num_gaussians, m.cutoff
    with torch.no_grad():
        x = blk.conv.lin1(m.embedding(batch.atom_type))

    def schnet_pair(pos, mask):
        dist, adj = m.geometry(pos, mask)
        return dist, m.envelope(dist, adj)

    p = net_p.model
    wk, bk = p.filter_weights()[0]
    with torch.no_grad():
        xp = p.interactions[0].interatomic_context_net(p.embed(batch.atom_type))
        gen = torch.Generator(xp.device).manual_seed(SEED)
        mu = 0.1 * torch.randn(xp.shape, generator=gen, device=xp.device)

    def painn_pair(pos, mask):
        dist, direction, gate = p.geometry(pos, mask)
        return (dist, gate, *(direction[..., c].contiguous() for c in range(3)))

    cases = [
        ("cfconv_bwd", "cfconv_fwd", schnet_pair, (x, *blk.filter_weights()),
         lambda *a: K.cfconv_fused(*a, 0.0, cut, g),
         lambda *a: K.cfconv_fused_reference(*a, 0.0, cut, g)),
        ("cfconv_bwd_sym", "cfconv_fwd_sym", schnet_pair,
         (x, *blk.filter_weights()),
         lambda *a: K.cfconv_fused_sym(*a, 0.0, cut, g),
         lambda *a: K.cfconv_fused_reference(*a, 0.0, cut, g)),
        ("painn_bwd", "painn_fwd", painn_pair, (xp, mu, wk, bk),
         lambda *a: P.painn_message_fused(*a, p.cutoff),
         lambda *a: P.painn_message_reference(*a, p.cutoff)),
        ("painn_bwd_sym", "painn_fwd_sym", painn_pair, (xp, mu, wk, bk),
         lambda *a: P.painn_message_fused_sym(*a, p.cutoff),
         lambda *a: P.painn_message_reference(*a, p.cutoff)),
    ]
    names = ("positions", "x", "W1/mu", "b1/Wk", "W2/bk", "b2")
    for bwd, fwd, pair_of, ins, op, ref in cases:
        reset_launch_counts()
        got = second_order_chain(op, pair_of, batch.positions,
                                 batch.node_mask, ins)
        torch.cuda.synchronize()
        counts = launch_counts()
        if (counts[fwd], counts[bwd]) != (1, 2):
            fail(f"second order through {fwd}: launches {fwd} "
                 f"{counts[fwd]}, {bwd} {counts[bwd]} (want 1 and 2)")
        want = second_order_chain(ref, pair_of, batch.positions,
                                  batch.node_mask, ins)
        errs = []
        for name, a, w in zip(names, got, want):
            err = (a - w).abs().max().item()
            atol = ATOL * w.abs().max().item()
            errs.append(f"{name} {err:.2e}")
            if not torch.isfinite(a).all() or \
                    not (a - w).abs().le(atol + RTOL * w.abs()).all():
                fail(f"second order of {bwd} at MD17 B={x.shape[0]} N="
                     f"{x.shape[1]}: d{name} max_abs_err {err:.3e} beyond "
                     f"rtol {RTOL} atol {atol:.3e}")
        print(f"second order of {bwd} (MD17 B={x.shape[0]} N={x.shape[1]}, "
              f"{fwd} once, {bwd} twice): max_abs_err " + ", ".join(errs))


def md17_path(dev, model_3d, pretrained, kernels):
    """Phase 3f for one backbone: ``finetune_md17.main`` for one epoch from
    the DDM ``model.pth`` (launch counts, finite losses and MAEs), one step
    on a freshly seeded net (the forward kernel once per block, the
    backward kernel twice) held to the plain step, the best ``model.pth``
    through ``Predictor.predict_forces`` on the test split against the
    plain path's energies and forces, and the ``md17:`` line. Returns
    (the step's launch counts, the seeded net, its first batch)."""
    import math

    import torch

    from geossl_tpu_torch.data.bucketing import BucketedLoader
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import finetune_md17 as FM

    run_dir = os.path.join(ROOT, "runs", f"chip_smoke_md17_{model_3d}")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = MD17_FLAGS + ["--model_3d", model_3d, "--input_model_file",
                         pretrained, "--output_model_dir", run_dir,
                         "--device", str(dev)]
    reset_launch_counts()
    t0 = time.time()
    _, best, (test_e, test_f), losses = FM.main(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"main path (md17 fine-tune, {model_3d}): {len(losses)} steps and "
          f"one val/test pass in {time.time() - t0:.2f} s (first call); "
          f"launches {counts}")
    for name in kernels:
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the MD17 {model_3d} path")
    if not losses or not all(math.isfinite(v) for v in losses) or \
            not all(math.isfinite(v) for v in (best, test_e, test_f)):
        fail(f"md17 {model_3d}: losses {losses[:4]}..., best val F MAE "
             f"{best}, test E/F MAE {test_e}/{test_f}")
    print(f"md17 {model_3d}: {len(losses)} finite losses, first "
          f"{losses[:3]}, last {losses[-3:]}; best val F MAE {best}; test "
          f"E/F MAE {test_e}/{test_f}")

    # one step on a freshly seeded net and the first training batch (5
    # frames at bucket 32): its launches, then the plain step
    args = FM.build_parser().parse_args(argv)
    cfg = common.model_config_from_args(args)
    buckets = common.buckets(args)
    splits = FM.load_splits(args)
    n_blocks = (cfg.schnet.num_interactions if model_3d == "schnet"
                else cfg.painn.n_interactions)
    net = FM.make_net(args, cfg, torch.Generator().manual_seed(SEED)).to(dev)
    loss_fn = FM.make_loss_fn(args.md17_energy_coeff, args.md17_force_coeff)
    train = BucketedLoader(splits[0], args.MD17_train_batch_size, buckets,
                           seed=SEED, with_forces=True)
    batch = next(iter(train.epoch(1))).to(dev)
    reset_launch_counts()
    loss_k, grads_k = grads_in_chunks(net, batch,
                                      lambda sb, sl: loss_fn(net, sb))
    torch.cuda.synchronize()
    step_counts = {k: v for k, v in launch_counts().items() if v}
    fwd, bwd = kernels
    if step_counts != {fwd: n_blocks, bwd: 2 * n_blocks}:
        fail(f"md17 {model_3d}: one step launched {step_counts}; want {fwd} "
             f"{n_blocks} and {bwd} {2 * n_blocks} times")
    print(f"md17 {model_3d} step launches: {step_counts} ({n_blocks} blocks: "
          "the forward once, the backward for the force and again in the "
          "loss's backward)")
    net.plain = True
    loss_p, grads_p = grads_in_chunks(net, batch,
                                      lambda sb, sl: loss_fn(net, sb))
    net.plain = False
    check_step_parity(f"MD17-{model_3d} step parity bucket "
                      f"{batch.max_atoms}", loss_k, grads_k, loss_p, grads_p)

    # the best model.pth served: energies and forces of the test split
    # through predict_forces (per-block kernels and their backwards)
    # against the plain path on the same weights
    test = splits[2]
    pred = Predictor.from_checkpoint(os.path.join(run_dir, "model.pth"), cfg,
                                     batch_size=args.eval_batch_size,
                                     bucket_sizes=buckets, device=dev)
    reset_launch_counts()
    energies, forces = pred.predict_forces(test)
    torch.cuda.synchronize()
    served = {k: v for k, v in launch_counts().items() if v}
    if set(served) != set(kernels):
        fail(f"md17 {model_3d}: predict_forces launched {served}; want "
             f"{kernels} only")
    e_p, f_p = plain_forces(pred, test)
    check_forces(f"md17 {model_3d} predict_forces: {len(test)} test energies",
                 energies, e_p)
    check_forces(f"md17 {model_3d} predict_forces: {forces.shape[0]} test "
                 "atoms' forces", forces, f_p)

    # throughput: optimizer steps and eval passes, untraced, then one
    # traced step
    opt, sched = common.make_optimizer_from_args(args, net.parameters(), 100)
    frames = int(batch.graph_mask.sum())

    def step():
        return common.finetune_step(net, opt, sched, [batch], loss_fn)

    evaluate = FM.make_evaluate(dev)
    val_loader = BucketedLoader(splits[1], args.eval_batch_size, buckets,
                                shuffle=False, with_forces=True)
    device_profile(step)  # profiler start-up
    train_s = median_s(step)
    eval_s = median_s(lambda: evaluate(net, val_loader))
    serve_s = median_s(lambda: pred.predict_forces(test))
    wall, busy, ours = device_profile(step)
    print("md17: " + json.dumps({
        "model": model_3d, "bucket": batch.max_atoms, "frames": frames,
        "epoch_steps": len(losses), "s_per_step": train_s,
        "train_frames_per_s": frames / train_s,
        "eval_frames": len(splits[1]), "eval_frames_per_s":
        len(splits[1]) / eval_s, "predict_forces_frames_per_s":
        len(test) / serve_s, "device_ms_per_step": busy * 1e3,
        "port_kernels_ms": ours * 1e3, "other_device_ms": (busy - ours) * 1e3,
        "traced_wall_ms": wall * 1e3, "idle_share": 1.0 - busy / wall,
        "best_val_f_mae": best, "test_e_mae": test_e, "test_f_mae": test_f}))
    print_top_ops(step, model_3d, "finetune_md17", batch.max_atoms)
    return step_counts, net, batch


# Phase 3g: the pretraining objectives beyond DDM (pretrain_geossl's
# InfoNCE, EBM_NCE and RR; pretrain_baselines' six), per backbone at full
# width: each driver for one short epoch over PRETRAIN_STORE synthetic
# Molecule3D molecules (buckets 32/64/128, batch 128), and one step per
# objective at bucket 128 (B=128) with kernels against the plain step
PRETRAIN_RUNS = (("geossl", "InfoNCE"), ("geossl", "EBM_NCE"),
                 ("geossl", "RR"), ("baseline", "supervised"),
                 ("baseline", "charge"), ("baseline", "distance"),
                 ("baseline", "torsion"), ("baseline", "infograph"),
                 ("baseline", "contextpred"))
PRETRAIN_STORE = 256
PATH_KERNELS = {"schnet": ("cfconv_fwd_sym", "cfconv_bwd_sym"),
                "painn": ("painn_fwd", "painn_bwd")}


def pretrain_args(driver, objective, model_3d):
    """The driver's parsed flags for ``objective`` at its defaults."""
    from geossl_tpu_torch.train import pretrain_baselines as PB
    from geossl_tpu_torch.train import pretrain_geossl as PG

    flags = ["--model_3d", model_3d]
    if driver == "geossl":
        return PG.build_parser().parse_args(["--GeoSSL_option", objective,
                                             *flags])
    return PB.build_parser(objective).parse_args(flags)


def objective_net(driver, objective, model_3d, store, dev):
    """The driver's module for ``objective``, freshly seeded, on ``dev``."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_baselines as PB
    from geossl_tpu_torch.train import pretrain_geossl as PG

    args = pretrain_args(driver, objective, model_3d)
    cfg = common.model_config_from_args(args)
    gen = torch.Generator().manual_seed(SEED)
    if driver == "geossl":
        return PG.make_graph_ssl(args, cfg, gen).to(dev)
    return PB.make_baseline(objective, args, cfg, store,
                            common.buckets(args)[-1], gen).to(dev)


def objective_draws(net, batch):
    """The step's random draws, seeded: the perturbed view (GeoSSL), or the
    baseline's one draw (charge's uniforms, torsion's, contextpred's
    centres; none for the others)."""
    import torch

    from geossl_tpu_torch.objectives import contrastive, contextpred
    from geossl_tpu_torch.train.pretrain_baselines import Baseline

    gen = torch.Generator(batch.positions.device).manual_seed(SEED)
    dev = batch.positions.device
    if not isinstance(net, Baseline):
        return contrastive.perturb_positions(gen, batch.positions, 0.0, 0.3)
    b, n = batch.node_mask.shape
    if net.objective == "charge":
        return torch.rand((b, n), generator=gen, device=dev)
    if net.objective == "torsion":
        return torch.rand((b, net.hparams["num_triples"], 3), generator=gen,
                          device=dev)
    if net.objective == "contextpred":
        return contextpred.sample_centers(gen, batch.node_mask).argmax(-1)
    return None


class backbones_in_chunks:
    """Within the block, the module's backbones (``model``, contextpred's
    ``context_model``) run in graph chunks under activation checkpointing:
    the plain versions' [B,N,N,F] grids of one chunk live at a time. The
    step's math is unchanged (a chunk's graphs never meet in a backbone)."""

    def __init__(self, net, chunk):
        self.mods = [m for m in (getattr(net, "model", None),
                                 getattr(net, "context_model", None))
                     if m is not None]
        self.chunk = chunk

    def __enter__(self):
        import torch
        from torch.utils.checkpoint import checkpoint

        def chunked(m):
            def forward(atom_type, positions, node_mask, pair_mask=None,
                        plain=False):
                outs = []
                for s in range(0, atom_type.shape[0], self.chunk):
                    sl = slice(s, s + self.chunk)
                    kw = {"plain": plain}
                    if pair_mask is not None:
                        kw["pair_mask"] = pair_mask[sl]
                    outs.append(checkpoint(
                        lambda z, p, mk, kw=kw: type(m).forward(m, z, p, mk,
                                                                **kw),
                        atom_type[sl], positions[sl], node_mask[sl],
                        use_reentrant=False))
                return tuple(torch.cat(parts) for parts in zip(*outs))
            return forward

        for m in self.mods:
            m.forward = chunked(m)
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            del m.forward


def zero_grad_params(net):
    """The parameters of ``net`` whose gradient is zero in exact
    arithmetic: RR's biases before each AutoEncoder's BatchNorm (it removes
    them), and, with the targets detached and SchNet's mean readout, the
    backbone's last bias (it shifts every graph representation alike, which
    the BatchNorm removes)."""
    from geossl_tpu_torch.models.schnet import SchNet

    if getattr(net, "option", None) != "RR":
        return ()
    names = ["AE_01.fc_layers.0.bias", "AE_02.fc_layers.0.bias"]
    if (isinstance(net.model, SchNet) and net.model.readout == "mean"
            and net.AE_01.detach_target and net.AE_02.detach_target):
        names.append("model.lin2.bias")
    return tuple(names)


def objective_parity(net, batch, what):
    """One step of ``net`` at this batch with kernels against the same step
    with the plain versions (its backbones in chunks of 16 graphs), the
    same draws and weights: the loss and every gradient
    (``check_step_parity``), and the buffers the step updates (RR's
    BatchNorm statistics) elementwise at rtol RTOL / atol ATOL."""
    import contextlib

    import torch

    from geossl_tpu_torch.train.pretrain_baselines import Baseline

    draw = objective_draws(net, batch)
    before = {k: v.clone() for k, v in net.named_buffers()}
    results = []
    for plain in (False, True):
        for k, v in net.named_buffers():
            v.copy_(before[k])
        net.zero_grad(set_to_none=True)
        net.plain = plain
        with (backbones_in_chunks(net, 16) if plain
              else contextlib.nullcontext()):
            loss, _ = (net(batch, draw=draw) if isinstance(net, Baseline)
                       else net(batch, draw))
            loss.backward()
        results.append((loss.item(), {n: p.grad.detach().clone()
                                      for n, p in net.named_parameters()},
                        {k: v.clone() for k, v in net.named_buffers()}))
    net.plain = False
    (loss_k, grads_k, bufs_k), (loss_p, grads_p, bufs_p) = results
    check_step_parity(what, loss_k, grads_k, loss_p, grads_p,
                      zero_grad_params(net))
    for k in bufs_p:
        if torch.equal(bufs_p[k], before[k]):
            fail(f"{what}: the step left buffer {k} unchanged")
        if not torch.allclose(bufs_k[k], bufs_p[k], rtol=RTOL, atol=ATOL):
            err = (bufs_k[k] - bufs_p[k]).abs().max().item()
            fail(f"{what}: buffer {k} differs by {err:.3e} (kernels vs plain)")
    if bufs_p:
        err = max((bufs_k[k] - bufs_p[k]).abs().max().item() for k in bufs_p)
        print(f"{what}: {len(bufs_p)} BatchNorm statistics after the step, "
              f"max_abs_err {err:.3e}")


def check_holed_masks(errs, net_s, net_p, batch):
    """#3/#4 (SchNet) and #8/#9 (PaiNN), forward and backward, against their
    plain versions on block 0's inputs under contextpred's substruct and
    context node masks (the driver's defaults, this batch's centres): holes
    in the middle of a graph. dist and env (PaiNN: dist and gate) must stay
    symmetric for the symmetric CFConv pair. Prints ``contextpred_masks:``."""
    from dataclasses import replace

    import torch

    from geossl_tpu_torch.objectives import contextpred as C
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.ops import painn as P

    mine, errs_all = Errors(), errs
    errs = mine  # this check's own largest errors, for its line
    hp = net_s.hparams
    k = hp["context_hops"]
    l1, l2 = k - 1, k - 1 + hp["context_csize"]
    mask = batch.node_mask
    dist, pm = geometry.pairwise_distances(batch.positions, mask)
    adj = geometry.radius_adjacency(dist, pm, hp["context_bond_cutoff"])
    centers = C.sample_centers(None, mask, objective_draws(net_s, batch))
    hops = C.hop_distances(adj, centers, l2)
    sub, ctx, ov = C.context_masks(hops, mask, k, l1, l2)
    n = mask.shape[1]
    line = {"batch": f"B={mask.shape[0]} N={n}", "real_atoms":
            int(mask.sum()), "overlap_graphs": int((ov.sum(-1) > 0).sum())}
    gen = torch.Generator(mask.device).manual_seed(SEED)
    m_s, m_p = net_s.model, net_p.model
    for name, hole in (("substruct", sub), ("context", ctx)):
        prefix = torch.arange(n, device=mask.device) < hole.sum(-1, keepdim=True)
        holed = int((hole != prefix).any(-1).sum())
        if holed == 0:
            fail(f"contextpred {name} mask: no graph has a hole")
        with torch.no_grad():
            d, a = m_s.geometry(batch.positions, hole)
            env = m_s.envelope(d, a).contiguous()
            d = d.contiguous()
            x = m_s.interactions[0].conv.lin1(
                m_s.embedding(batch.atom_type)).contiguous()
            fw = m_s.interactions[0].filter_weights()
        if not (torch.equal(d, d.transpose(1, 2))
                and torch.equal(env, env.transpose(1, 2))):
            fail(f"contextpred {name} mask: dist/env not symmetric")
        cut, G = m_s.cutoff, m_s.num_gaussians
        with torch.no_grad():
            want = chunked(K.cfconv_fused_reference, (d, env, x),
                           (*fw, 0.0, cut, G), 16)
            for sp in (False, True):
                errs.check("cfconv_fwd_sym", K.cfconv_fused_sym(
                    d, env, x, *fw, 0.0, cut, G, sp), want,
                    f"contextpred {name} mask sparse={sp}")
        gx = torch.randn(x.shape, generator=gen, device=x.device)
        check_cfconv_bwd_sym(errs, d, env, x, gx, fw, G, cut,
                             f"contextpred {name} mask", chunk=16)
        grids, q0, xp, mu = painn_inputs(m_p, replace(batch, node_mask=hole))
        if not (torch.equal(grids[0], grids[0].transpose(1, 2))
                and torch.equal(grids[1], grids[1].transpose(1, 2))):
            fail(f"contextpred {name} mask: PaiNN dist/gate not symmetric")
        with torch.no_grad():
            wk, bk = m_p.filter_weights()[0]
            want = chunked(lambda *t: torch.cat(P.painn_message_reference(
                *t, wk, bk, m_p.cutoff), dim=-1), (*grids, xp, mu), (), 16)
            for sp in (False, True):
                errs.check("painn_fwd", torch.cat(P.painn_message_fused(
                    *grids, xp, mu, wk, bk, m_p.cutoff, sp), dim=-1), want,
                    f"contextpred {name} mask sparse={sp}")
        gq = torch.randn(q0.shape, generator=gen, device=q0.device)
        gmu = torch.randn(mu.shape, generator=gen, device=q0.device)
        check_painn_bwd(errs, grids, xp, mu, wk, bk, gq, gmu, m_p.cutoff,
                        f"contextpred {name} mask", chunk=8)
        line[name] = {"atoms": int(hole.sum()), "holed_graphs": holed,
                      "schnet_pairs": int((env != 0).sum()),
                      "painn_pairs": int((grids[1] != 0).sum())}
    line["max_abs_err"] = mine.max_abs
    for k, v in mine.max_abs.items():
        errs_all.max_abs[k] = max(errs_all.max_abs.get(k, 0.0), v)
    print("contextpred_masks: " + json.dumps(line))


@contextlib.contextmanager
def chain_calls():
    """The group length of every ``common.ChainStep`` call on the card made
    inside the block (each such call is one CUDA graph replay)."""
    from geossl_tpu_torch.train import common

    calls, call = [], common.ChainStep.__call__

    def counted(self, group):
        out = call(self, group)
        if self.device.type == "cuda":
            calls.append(len(group))
        return out

    common.ChainStep.__call__ = counted
    try:
        yield calls
    finally:
        common.ChainStep.__call__ = call


def pretrain_driver(dev, driver, objective, model_3d, batch, card):
    """One driver ``main()`` for one epoch on the card (the path kernels
    launched, finite losses, ``model.pth`` served by a Predictor), then its
    module's steps at ``batch`` (bucket 128): launches per step, median step
    ms, one traced step; prints the ``pretrain:`` line. Returns the step's
    launch counts."""
    import math

    import numpy as np
    import torch

    from geossl_tpu_torch.data.synthetic import synthetic_molecule3d
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_baselines as PB
    from geossl_tpu_torch.train import pretrain_geossl as PG

    run_dir = os.path.join(ROOT, "runs",
                           f"chip_smoke_pretrain_{model_3d}_{objective}")
    shutil.rmtree(run_dir, ignore_errors=True)
    flags = ["--synthetic", "--synthetic_size", str(PRETRAIN_STORE),
             "--synthetic_max_atoms", "100", "--epochs", "1",
             "--output_model_dir", run_dir, "--model_3d", model_3d]
    reset_launch_counts()
    t0 = time.time()
    if driver == "geossl":
        module, losses = PG.main(["--GeoSSL_option", objective, *flags])
        graph_steps = None
    else:
        # the baselines' epoch with --steps_per_call: every step must be in
        # a CUDA graph replay (ChainStep's calls on the card replay, or
        # raise), which the calls' group lengths count
        with chain_calls() as calls:
            module, losses = PB.main([objective, *flags, "--steps_per_call",
                                      str(HOST_K)])
        graph_steps = sum(calls)
        if graph_steps != len(losses):
            fail(f"pretrain {objective} {model_3d} --steps_per_call "
                 f"{HOST_K}: {graph_steps} of {len(losses)} steps in graph "
                 "replays")
    torch.cuda.synchronize()
    epoch_s = time.time() - t0
    counts = launch_counts()
    for name in PATH_KERNELS[model_3d]:
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the {objective} "
                 f"{model_3d} path")
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"pretrain {objective} {model_3d}: losses {losses}")
    args = pretrain_args(driver, objective, model_3d)
    cfg = common.model_config_from_args(args)
    emb = Predictor.from_checkpoint(
        os.path.join(run_dir, "model.pth"), cfg, batch_size=128,
        bucket_sizes=common.buckets(args), device=dev).embed(synthetic_molecule3d(
            64, seed=3, max_atoms=100))
    if emb.shape != (64, cfg.emb_dim) or not np.isfinite(emb).all():
        fail(f"pretrain {objective} {model_3d}: model.pth served shape "
             f"{emb.shape} or non-finite")

    opt, sched = common.make_optimizer_from_args(args, module.parameters(),
                                                 100)
    loss_of = (PG.loss_of(module, args) if driver == "geossl"
               else lambda b, g: module(b, g))
    gen = torch.Generator(dev).manual_seed(SEED)

    def step():
        return common.pretrain_step(module, opt, sched, [batch],
                                    lambda b: loss_of(b, gen))

    step()  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    step()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in launch_counts().items() if v}
    step_s = median_s(step)
    device_profile(step)  # profiler start-up
    wall, busy, ours = device_profile(step)
    print("pretrain: " + json.dumps({
        "objective": objective, "model": model_3d, "bucket": batch.max_atoms,
        "molecules": int(batch.graph_mask.sum()), "epoch_steps": len(losses),
        "epoch_graph_steps": graph_steps,
        "epoch_s_first_call": epoch_s, "step_ms": step_s * 1e3,
        "mol_per_s": int(batch.graph_mask.sum()) / step_s,
        "device_ms_per_step": busy * 1e3, "port_kernels_ms": ours * 1e3,
        "traced_wall_ms": wall * 1e3, "idle_share": 1.0 - busy / wall,
        "launches_per_step": per_step,
        "epoch_launches": {k: v for k, v in counts.items() if v},
        "card": card}))
    return per_step, None if graph_steps is None else counts


def pretrain_path(errs, dev, card, batch_of):
    """Phase 3g: per backbone, every objective's step parity at bucket 128,
    the holed-mask kernel checks, every driver's epoch and its
    ``pretrain:`` line. Returns ({"<model>/<objective>": launches per
    step}, {"<model>/<baseline>": launches in its --steps_per_call epoch,
    the graphs' captures and warm-ups})."""
    from geossl_tpu_torch.data.molecule3d import load_molecule3d

    store = load_molecule3d("", synthetic=True,
                            synthetic_size=PRETRAIN_STORE,
                            synthetic_max_atoms=100)
    batch = batch_of(128)
    nets = {}
    for model_3d in ("schnet", "painn"):
        for driver, objective in PRETRAIN_RUNS:
            net = objective_net(driver, objective, model_3d, store, dev)
            objective_parity(net, batch, f"pretrain {objective}-{model_3d} "
                             "step parity bucket 128")
            nets[model_3d, objective] = net
    check_holed_masks(errs, nets["schnet", "contextpred"],
                      nets["painn", "contextpred"], batch)
    del nets
    launches, graph_launches = {}, {}
    for model_3d in ("schnet", "painn"):
        for driver, objective in PRETRAIN_RUNS:
            run = f"{model_3d}/{objective}"
            launches[run], counts = pretrain_driver(
                dev, driver, objective, model_3d, batch, card)
            if counts is not None:
                graph_launches[run] = counts
    return launches, graph_launches


# -- Phase 3h: the rest of serving -------------------------------------------
# LEP pair serving at bucket 512 (and one mixed 128x512 pair), sealed
# artifacts over the ladder (32, 128, 512) in all four modes (pairs over
# [512]) held to the live Predictor, the kernels counted inside the sealed
# programs by the profiler, .sdf input through the CLI, and the custom ops'
# host cost per launch
SEAL_LADDER = (32, 128, 512)
# each serving kernel's entry function, as the profiler names it
# (demangled): the sealed programs must run these and no plain version
SEALED_KERNELS = {"schnet_stack": "schnet_stack_kernel",
                  "cfconv_fwd_sym": "cfconv_fwd_sym_kernel",
                  "cfconv_bwd_sym": "cfconv_bwd_kernel<true",
                  "painn_stack": "painn_stack_kernel<false",
                  "painn_fwd": "painn_fwd_mma_kernel<3, false",
                  "painn_bwd": "painn_bwd_mma_kernel<false",
                  "painn_fwd_sym": "painn_fwd_mma_kernel<3, true",
                  "painn_bwd_sym": "painn_bwd_mma_kernel<true"}
# the serving kernels each backbone's sealed passes must run (PaiNN at
# N=512 through its symmetric pair; its forces at N <= 128 through the
# plain pair)
SEALED_PATH = {"schnet": ("schnet_stack", "cfconv_fwd_sym", "cfconv_bwd_sym"),
               "painn": ("painn_stack", "painn_fwd_sym", "painn_bwd_sym",
                         "painn_fwd", "painn_bwd")}
# the index-coded atom types' element symbols (8, unknown: a symbol the
# featurizer does not know)
SDF_SYMBOLS = ("H", "C", "N", "O", "F", "P", "S", "Cl", "Xx")


def kernel_calls(fn):
    """{kernel name: launches} of the port's kernels (``geossl::``) in one
    traced call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "geossl::" in e.name:
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def by_table_name(calls):
    """{table kernel: launches} from ``kernel_calls``' names."""
    return {k: sum(c for name, c in calls.items() if sub in name)
            for k, sub in SEALED_KERNELS.items()}


def table_kernel_calls(fn, tries=3):
    """``by_table_name(kernel_calls(fn))``, each kernel's largest count over
    ``tries`` traced calls: the profiler may drop a kernel's record (one
    of six went missing in one run), it never adds one."""
    runs = [by_table_name(kernel_calls(fn)) for _ in range(tries)]
    return {k: max(r[k] for r in runs) for k in SEALED_KERNELS}


def host_us_per_call(fn, reps=400):
    """Host microseconds per call of fn, issued back to back (the device
    runs behind: a small launch keeps it from setting the pace)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def custom_op_overhead(dev):
    """The host cost of a launch through its custom op against the launch
    code called directly: ``cfconv_fwd`` in symmetric mode on one graph of
    32 atoms (a device time of a few microseconds), five rounds in turns;
    prints the ``custom_op_overhead:`` line and returns the median extra
    microseconds per launch."""
    import math

    import torch

    from geossl_tpu_torch.ops import _launch
    from geossl_tpu_torch.ops import cfconv as K

    gen = torch.Generator(dev).manual_seed(SEED)
    pos = torch.randn((1, 32, 3), generator=gen, device=dev) * 2.0
    dist = torch.cdist(pos, pos).contiguous()
    env = (0.5 * (torch.cos(dist * math.pi / 10.0) + 1.0)).contiguous()
    x = torch.randn((1, 32, 128), generator=gen, device=dev)
    w1, b1 = (torch.randn(s, generator=gen, device=dev) * 0.1
              for s in ((51, 128), (128,)))
    w2, b2 = (torch.randn(s, generator=gen, device=dev) * 0.1
              for s in ((128, 128), (128,)))
    args = (dist, env, x, w1, b1, w2, b2, 0.0, 10.0, 51, True, False)
    op = _launch.OPS["cfconv_fwd"]
    # the symmetric mode sums with atomics: the same within f32 rounding
    if not torch.allclose(op(*args), K._launch_cfconv(*args), rtol=RTOL,
                          atol=ATOL):
        fail("custom_op_overhead: the op and the launch code disagree")
    rounds = {"direct": [], "op": []}
    for _ in range(5):
        rounds["direct"].append(host_us_per_call(
            lambda: K._launch_cfconv(*args)))
        rounds["op"].append(host_us_per_call(lambda: op(*args)))
    med = {k: sorted(v)[2] for k, v in rounds.items()}
    extra = med["op"] - med["direct"]
    # eager calls run the launch code directly (ops/_launch.launch): the
    # route for an op that adds more than 5 us a launch
    print("custom_op_overhead: " + json.dumps({
        "kernel": "cfconv_fwd_sym", "shape": "B=1 N=32",
        "direct_us": med["direct"], "op_us": med["op"], "extra_us": extra,
        "rounds_us": rounds, "eager_route": "direct",
        "route_follows": extra > 5.0}))
    return extra


def write_sdf(path, store, idx):
    """The molecules ``idx`` of ``store`` as V2000 SDF blocks (no bonds;
    index-coded atom types as their element symbols)."""
    with open(path, "w") as f:
        for i in idx:
            r = store.get(int(i))
            f.write(f"mol{i}\n  chip_smoke\n\n{r.num_atoms:3d}  0  0  0  0  0"
                    "  0  0  0  0999 V2000\n")
            for t, (x, y, z) in zip(r.atom_type, r.positions):
                f.write(f"{x:10.4f}{y:10.4f}{z:10.4f} "
                        f"{SDF_SYMBOLS[int(t)]:<3} 0  0  0  0  0  0  0  0"
                        "  0  0  0  0\n")
            f.write("M  END\n$$$$\n")


def pair_logits(pred, active, inactive, idx, chunk=4):
    """(kernel logits, plain logits) of the pairs ``idx`` (one bucket
    pair), both towers through the Predictor's route and through
    ``model(plain=True)`` on the same packed chunks of ``chunk`` pairs; the
    stores as the Predictor sorts them. The logits, not only the
    probabilities: a seeded head may saturate the sigmoid."""
    import numpy as np
    import torch

    from geossl_tpu_torch.data.bucketing import assign_buckets

    na = assign_buckets(active.num_atoms(), pred.bucket_sizes)
    ni = assign_buckets(inactive.num_atoms(), pred.bucket_sizes)
    if len(set(zip(na[idx], ni[idx]))) != 1:
        fail("pair_logits: the pairs span several bucket pairs")
    got, want = [], []
    packers = [(pred._packer(st), nb) for st, nb in ((active, na),
                                                     (inactive, ni))]
    with torch.inference_mode():
        for s in range(0, len(idx), chunk):
            part = idx[s:s + chunk]
            towers = [pack(part, int(nb[part[0]]), len(part))
                      for pack, nb in packers]
            args = [t for tw in towers
                    for t in (tw.atom_type, tw.positions, tw.node_mask)]
            got.append(pred._pair_logit_fn(pred._prep, *args).cpu().numpy())
            graphs = [pred.model(t.atom_type, t.positions, t.node_mask,
                                 plain=True)[0] for t in towers]
            want.append(pred.head(*graphs).cpu().numpy())
    return np.concatenate(got), np.concatenate(want)


def check_close(what, got, want):
    """Elementwise within rtol RTOL and atol ATOL times max|want|."""
    import numpy as np

    atol = ATOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all() or \
            not (np.abs(got - want) <= atol + RTOL * np.abs(want)).all():
        fail(f"{what}: max_abs_err {err:.3e} beyond rtol {RTOL} atol "
             f"{atol:.3e} (shapes {got.shape}, {want.shape})")
    return err


def serving_rest_path(dev, card, single, dual, serve_store):
    """Phase 3h for both backbones. ``single[model_3d]`` / ``dual[model_3d]``
    are checkpoint paths with a single head / LEP's dual head at full width;
    ``serve_store`` is the serving store (molecules of 3–100 atoms and LBA
    complexes of up to 512). Returns ({model_3d: pairs launches},
    {model_3d: {kernel: sealed launches}})."""
    import numpy as np
    import torch

    from geossl_tpu_torch import serve
    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.data.store import MolStore
    from geossl_tpu_torch.data.synthetic import synthetic_lep
    from geossl_tpu_torch.export import SealedPredictor, seal
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor

    custom_op_overhead(dev)
    # 64 LEP pairs at bucket 512 (both conformations 257-512 atoms) and one
    # mixed pair: an active of 65-128 atoms against an inactive at 512
    act, inact, _ = synthetic_lep(256, seed=5, max_atoms=512)
    sizes = act.num_atoms()
    big = np.nonzero(sizes > 256)[0][:64]
    small = np.nonzero((sizes > 64) & (sizes <= 128))[0][:1]
    if len(big) < 64 or len(small) < 1:
        fail("phase 3h: the synthetic LEP draw lacks pairs at 512 or 128")
    active = act.select(np.concatenate([big, small]))
    inactive = inact.select(np.concatenate([big, big[:1]]))
    mixed = len(big)  # the last pair: 128 x 512
    work = os.path.join(ROOT, "runs", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pairs_launches, sealed_launches = {}, {}
    for model_3d in ("schnet", "painn"):
        cfg = ModelConfig(model_3d=model_3d)
        # -- pairs: live, against the plain versions ----------------------
        pred_d = Predictor.from_checkpoint(dual[model_3d], cfg)
        reset_launch_counts()
        t0 = time.perf_counter()
        probs = pred_d.predict_pairs(active, inactive)
        first_s = time.perf_counter() - t0
        pairs_launches[model_3d] = {k: v for k, v in launch_counts().items()
                                    if v}
        for name in SEALED_PATH[model_3d][1:2]:
            if pairs_launches[model_3d].get(name, 0) == 0:
                fail(f"pairs {model_3d}: kernel {name} was not launched")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred_d.predict_pairs(active, inactive)
            times.append(time.perf_counter() - t0)
        steady = sorted(times)[1]
        sa, si = pred_d._maybe_sort(active), pred_d._maybe_sort(inactive)
        idx = np.arange(len(active))
        logits = [pair_logits(pred_d, sa, si, part)
                  for part in (idx[:mixed], idx[mixed:])]
        got_l, want_l = (np.concatenate(x) for x in zip(*logits))
        err_l = check_close(f"pair logits {model_3d} vs plain", got_l, want_l)
        want = 1.0 / (1.0 + np.exp(-want_l.astype(np.float64)))
        err = check_close(f"pairs {model_3d} vs plain", probs, want)
        print("pairs: " + json.dumps({
            "model": model_3d, "pairs": len(active),
            "buckets": {"512x512": mixed, "128x512": 1},
            "first_pass_s": first_s, "steady_pass_s": steady,
            "pairs_per_s": len(active) / steady,
            "logit_range": [float(want_l.min()), float(want_l.max())],
            "max_abs_err_vs_plain": {"logit": err_l, "probability": err},
            "launches": pairs_launches[model_3d], "card": card}))
        # -- sealed artifacts: all four modes ---------------------------------
        pred_s = Predictor.from_checkpoint(single[model_3d], cfg,
                                           bucket_sizes=SEAL_LADDER)
        pred_l = Predictor.from_checkpoint(dual[model_3d], cfg,
                                           bucket_sizes=SEAL_LADDER)
        path_s = os.path.join(work, f"{model_3d}.sealed")
        path_l = os.path.join(work, f"{model_3d}_lep.sealed")
        t0 = time.perf_counter()
        sizes_s = seal(pred_s, path_s, modes=("predict", "embed", "forces"))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sizes_l = seal(pred_l, path_l, modes=("pairs",), pair_buckets=(512,))
        export_l = time.perf_counter() - t0
        t0 = time.perf_counter()
        sealed = SealedPredictor.load(path_s)
        sealed_l = SealedPredictor.load(path_l)
        load_s = time.perf_counter() - t0
        store = serve_store
        modes = {
            "predict": (lambda p: p.predict(store)),
            "embed": (lambda p: p.embed(store)),
            "forces": (lambda p: np.concatenate(
                [a.reshape(-1) for a in p.predict_forces(store)])),
        }
        report = {"model": model_3d, "card": card,
                  "export_s": {"predict_embed_forces": export_s,
                               "pairs": export_l},
                  "programs": len(sizes_s) + len(sizes_l),
                  "artifact_mb": {"single": os.path.getsize(path_s) / 1e6,
                                  "lep": os.path.getsize(path_l) / 1e6},
                  "load_s": load_s, "modes": {}}
        counts = {}
        for mode, run in [*modes.items(),
                          ("pairs", None)]:
            if mode == "pairs":
                live_p, sealed_p = pred_l, sealed_l
                sub = [i for i in range(len(active)) if i != mixed]

                def run(p, sub=sub):
                    return p.predict_pairs(active.select(sub),
                                           inactive.select(sub))
            else:
                live_p, sealed_p = pred_s, sealed
            t0 = time.perf_counter()
            got = run(sealed_p)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            want = run(live_p)
            err = check_close(f"sealed {model_3d} {mode} vs live", got, want)
            laps = {"live": [], "sealed": []}
            for _ in range(3):
                for k, p in (("live", live_p), ("sealed", sealed_p)):
                    t0 = time.perf_counter()
                    run(p)
                    torch.cuda.synchronize()
                    laps[k].append(time.perf_counter() - t0)
            live_calls = table_kernel_calls(lambda: run(live_p))
            sealed_calls = table_kernel_calls(lambda: run(sealed_p))
            if sealed_calls != live_calls:
                fail(f"sealed {model_3d} {mode}: kernels {sealed_calls}, the "
                     f"live route runs {live_calls}")
            for k, v in sealed_calls.items():
                counts[k] = counts.get(k, 0) + v
            report["modes"][mode] = {
                "max_abs_err_vs_live": err, "first_pass_s": first,
                "steady_pass_s": {k: sorted(v)[1] for k, v in laps.items()},
                "kernels": {k: v for k, v in sealed_calls.items() if v}}
        for name in SEALED_PATH[model_3d]:
            if counts.get(name, 0) == 0:
                fail(f"sealed {model_3d}: kernel {name} never ran inside the "
                     "sealed programs")
        try:
            sealed_l.predict_pairs(active.select([mixed]),
                                   inactive.select([mixed]))
            fail("sealed pairs: a 128x512 pair outside the sealed [512] "
                 "pair ladder did not raise")
        except ValueError as e:
            if "pairs_128x512" not in str(e):
                raise
        sealed_launches[model_3d] = {k: v for k, v in counts.items() if v}
        print("sealed: " + json.dumps(report))
    # -- .sdf input through the CLI, live and sealed --------------------------
    sdf = os.path.join(work, "mols.sdf")
    write_sdf(sdf, serve_store, range(0, len(serve_store), 37))
    from_sdf = serve.store_from_sdf(sdf)
    live = Predictor.from_checkpoint(single["schnet"], ModelConfig(),
                                     bucket_sizes=SEAL_LADDER)
    want = live.predict(from_sdf)
    for ckpt in (single["schnet"], os.path.join(work, "schnet.sealed")):
        csv = os.path.join(work, "preds.csv")
        serve.main(["--ckpt", ckpt, "--input", sdf, "--output", csv,
                    "--bucket", *map(str, SEAL_LADDER)])
        rows = [line.split(",") for line in open(csv).read().splitlines()]
        got = np.asarray([float(r[1]) for r in rows], np.float32)
        check_close(f"serve --input .sdf --ckpt {os.path.basename(ckpt)}",
                    got, want)
    print("sdf: " + json.dumps({"molecules": len(from_sdf),
                                "atoms": int(from_sdf.offsets[-1]),
                                "served": ["pth", "sealed"]}))
    return pairs_launches, sealed_launches


# -- Phase 3i: the host runtime ---------------------------------------------
# The C++ packer against the NumPy pack, the drivers' loops in three modes
# (the parent's loop: NumPy packing, a blocking pageable upload, eager steps;
# the C++ packer and prefetch, eager; and both with --steps_per_call 8 as
# CUDA graphs), graph-replayed steps against eager steps, and one
# pretrain_geossl --profile_dir epoch

HOST_STEPS = 16  # steps per timed epoch: two calls of 8 in mode (c)
HOST_K = 8  # --steps_per_call in mode (c) and in the graph parity checks
HOST_MODES = ("a_parent_loop", "b_native_prefetch", "c_graphs_k8")
# graph_parity: a parameter beyond 10x GRAD_RTOL must stay within this many
# times the eager run-to-run spread of the same parameter
NOISE_FACTOR = 10
# graph_parity: eager pairs at most that sample a parameter's spread
SPREAD_PAIRS = 5
# graph_parity's cases: each ported driver step per backbone, the six
# baseline objectives (pretrain_baselines), and DDM-SchNet under
# --compute_dtype bfloat16 (a capture under bf16)
BASELINE_CASES_TASKS = ("supervised", "charge", "distance", "torsion",
                        "infograph", "contextpred")
BASELINE_CASES = tuple(f"{t}-{m}" for t in BASELINE_CASES_TASKS
                       for m in ("SchNet", "PaiNN"))
GRAPH_PARITY_CASES = tuple(f"{t}-{m}" for t in ("QM9", "MD17", "DDM", "LBA",
                                                "LEP")
                           for m in ("SchNet", "PaiNN")) + BASELINE_CASES + (
    "DDM-SchNet-bf16",)


def components(n, bond_index, keep=None):
    """Connected components of the bond graph on atoms ``keep`` (all n by
    default)."""
    import numpy as np

    keep = np.arange(n) if keep is None else keep
    parent = {int(i): int(i) for i in keep}

    def root(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in zip(*bond_index):
        if int(a) in parent and int(b) in parent:
            parent[root(int(a))] = root(int(b))
    return len({root(i) for i in parent})


def packer_check(card):
    """The ``packer:`` line: the C++ packer bitwise against the NumPy pack
    (QM9 at bucket 32, B=128; DDM's Molecule3D stand-in at 32/64/128), the
    fused BFS pack's invariants and the per-record BFS mask's relabelled
    bonds, and ms per batch of each."""
    import numpy as np

    from geossl_tpu_torch.data.bucketing import assign_buckets, pack_batch
    from geossl_tpu_torch.data.masking import apply_bfs_mask
    from geossl_tpu_torch.data.synthetic import synthetic_molecule3d, synthetic_qm9
    from geossl_tpu_torch.native import packing

    t0 = time.time()
    packing.load()
    build_s = time.time() - t0
    out = {"card": card, "build_s": build_s, "batches": []}
    stores = {"qm9": (synthetic_qm9(1024, seed=3), (32,)),
              "ddm": (synthetic_molecule3d(1024, seed=4, max_atoms=100),
                      (32, 64, 128))}
    ratio = 0.3
    for name, (store, ladder) in stores.items():
        flat = packing.StoreArrays(store, bonds=name == "ddm")
        bucket_of = assign_buckets(store.num_atoms(), ladder)
        for b in ladder:
            idx = np.nonzero(bucket_of == b)[0][:128]
            native = packing.pack_batch_from_store(flat, idx, b, 128)
            plain = pack_batch([store.get(int(i)) for i in idx], b, 128)
            for got, want, what in zip(
                    native, (plain.atom_type.numpy(), plain.positions.numpy(),
                             plain.node_mask.numpy(), plain.graph_mask.numpy(),
                             plain.y.numpy()),
                    ("atom_type", "positions", "node_mask", "graph_mask", "y")):
                if not np.array_equal(np.asarray(got, want.dtype), want):
                    fail(f"packer {name} bucket {b}: native {what} differs "
                         "from the NumPy pack")
            row = {"store": name, "bucket": b, "molecules": len(idx),
                   "native_ms": cuda_free_ms(lambda: packing.pack_batch_from_store(
                       flat, idx, b, 128)),
                   "numpy_ms": cuda_free_ms(lambda: pack_batch(
                       [store.get(int(i)) for i in idx], b, 128))}
            if name == "ddm":
                rng = np.random.default_rng(SEED)
                at, pos, nm, gm, _ = packing.pack_batch_bfs_from_store(
                    flat, idx, b, 128, ratio, rng)
                for slot, i in enumerate(idx):
                    rec = store.get(int(i))
                    n, kept = rec.num_atoms, int(nm[slot].sum())
                    want_n = n if n <= 1 else min(n, int(n * (1 - ratio)) + 1)
                    if kept != want_n or not nm[slot, :kept].all():
                        fail(f"packer: fused BFS kept {kept} of {n} atoms "
                             f"(want {want_n}), molecule {i}")
                    # the kept atoms, by their positions, in atom order
                    where = {tuple(p): k for k, p in enumerate(
                        rec.positions.tolist())}
                    keep = np.asarray([where[tuple(p)] for p in
                                       pos[slot, :kept].tolist()])
                    if (np.diff(keep) <= 0).any() or not np.array_equal(
                            at[slot, :kept], rec.atom_type[keep]):
                        fail(f"packer: fused BFS atoms of molecule {i} are "
                             "not an ordered subset")
                    if components(n, rec.bond_index, keep) > \
                            components(n, rec.bond_index):
                        fail(f"packer: fused BFS of molecule {i} keeps more "
                             "pieces than its bond graph has")
                    # the per-record mask (native bfs_subgraph): bonds
                    # relabelled onto the kept atoms
                    sub = apply_bfs_mask(rec, rng, ratio)
                    sub_keep = [where[tuple(p)] for p in
                                sub.positions.tolist()]
                    orig = {(int(a), int(c)) for a, c in zip(*rec.bond_index)}
                    mapped = {(sub_keep[a], sub_keep[c])
                              for a, c in zip(*sub.bond_index)}
                    kept_set = set(sub_keep)
                    if mapped != {(a, c) for a, c in orig
                                  if a in kept_set and c in kept_set}:
                        fail(f"packer: BFS mask of molecule {i}: relabelled "
                             "bonds are not the kept atoms' bonds")
                row["bfs_native_ms"] = cuda_free_ms(
                    lambda: packing.pack_batch_bfs_from_store(
                        flat, idx, b, 128, ratio, np.random.default_rng(1)))
                row["bfs_numpy_ms"] = cuda_free_ms(lambda: pack_batch(
                    [numpy_bfs(store.get(int(i)), ratio) for i in idx],
                    b, 128))
            out["batches"].append(row)
    print("packer: " + json.dumps(out))


def numpy_bfs(rec, ratio, rng=None):
    """The record path's BFS mask with the NumPy BFS (the parent's)."""
    import numpy as np

    os.environ["GEOSSL_NO_NATIVE"] = "1"
    try:
        from geossl_tpu_torch.data.masking import apply_bfs_mask

        return apply_bfs_mask(rec, rng or np.random.default_rng(2), ratio)
    finally:
        del os.environ["GEOSSL_NO_NATIVE"]


def cuda_free_ms(fn, reps=20):
    """Median host ms of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2] * 1e3


def host_path(dev, name):
    """(trainee, body, generator, loader factory, reseed) of one path of
    ``host_runtime:`` at full width with seeded weights: QM9, DDM and the
    six baseline objectives (``<objective>-<backbone>``, the
    pretrain_baselines driver's module at its defaults) at bucket 32
    (B=128), MD17 at batch 5; a ``-bf16`` suffix runs the path under
    ``--compute_dtype bfloat16``. ``loader(native)`` makes a loader of
    HOST_STEPS batches with the C++ packer on or off (MD17 packs its forces
    in NumPy either way, as the JAX loader does)."""
    import numpy as np
    import torch

    from geossl_tpu_torch.data.bucketing import BucketedLoader
    from geossl_tpu_torch.data.masking import make_bfs_transform
    from geossl_tpu_torch.data.synthetic import (
        synthetic_md17, synthetic_molecule3d, synthetic_qm9)
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import finetune_md17 as FM
    from geossl_tpu_torch.train import finetune_qm9 as FQ
    from geossl_tpu_torch.train import pretrain_baselines as PB
    from geossl_tpu_torch.train import pretrain_geossl as PG

    task, model_3d, *mode = name.split("-")
    model_3d = model_3d.lower()
    flags = ["--model_3d", model_3d, "--bucket", "32"]
    if mode == ["bf16"]:
        flags += ["--compute_dtype", "bfloat16"]
    gen = torch.Generator().manual_seed(SEED)
    generator = None
    if task in PB.OBJECTIVES:
        # the driver's defaults (torsion's triples from its largest default
        # bucket, 128), its batches at bucket 32
        args = PB.build_parser(task).parse_args(["--model_3d", model_3d])
        store = synthetic_molecule3d(128 * HOST_STEPS, seed=7, max_atoms=32)
        net = PB.make_baseline(task, args, common.model_config_from_args(args),
                               store, common.buckets(args)[-1], gen).to(dev)
        generator = torch.Generator(dev).manual_seed(SEED)
        body = common.pretrain_body(lambda b: net(b, generator))
        batch, kw = 128, {}
    elif task == "QM9":
        args = FQ.build_parser().parse_args(
            ["--model_3d", model_3d, "--lr", "5e-4", "--bucket", "32"])
        store = synthetic_qm9(128 * HOST_STEPS, seed=5)
        store.y = np.ascontiguousarray(store.y[:, :1])
        mean, std = float(store.y.mean()), float(store.y.std())
        net = FQ.make_net(args, common.model_config_from_args(args),
                          gen).to(dev)
        body = common.finetune_body(net, FQ.make_loss_fn("mae", mean, std))
        batch, kw = 128, {}
    elif task == "MD17":
        args = FM.build_parser().parse_args(
            ["--model_3d", model_3d, "--bucket", "32"])
        store = synthetic_md17(5 * HOST_STEPS, seed=6)
        net = FM.make_net(args, common.model_config_from_args(args),
                          gen).to(dev)
        body = common.finetune_body(net, FM.make_loss_fn(0.05, 0.95))
        batch, kw = 5, {"with_forces": True}
    else:
        args = PG.build_parser().parse_args(flags)
        store = synthetic_molecule3d(128 * HOST_STEPS, seed=7, max_atoms=32)
        net = PG.make_ddm(args, common.model_config_from_args(args),
                          gen).to(dev)
        generator = torch.Generator(dev).manual_seed(SEED)
        loss = PG.loss_of(net, args)
        body = common.pretrain_body(lambda b: loss(b, generator))
        batch, kw = 128, {"transform": make_bfs_transform(0.3)}
    opt, sched = common.make_optimizer_from_args(args, net.parameters(),
                                                 HOST_STEPS)

    def loader(native):
        if native:
            return BucketedLoader(store, batch, (32,), seed=SEED, **kw)
        os.environ["GEOSSL_NO_NATIVE"] = "1"
        try:
            return BucketedLoader(store, batch, (32,), seed=SEED, **kw)
        finally:
            del os.environ["GEOSSL_NO_NATIVE"]

    return net, opt, sched, body, generator, loader


def host_epochs(dev, name, mode, state):
    """fn() running one epoch of path ``name`` in ``mode``; ``state`` keeps
    the path's trainee across modes."""
    import torch

    from geossl_tpu_torch.parallel.mesh import prefetch
    from geossl_tpu_torch.train import common

    net, opt, sched, body, generator, make_loader = state
    loader = make_loader(mode != "a_parent_loop")
    chain = None
    if mode == "c_graphs_k8":
        chain = common.ChainStep(opt, sched, body, dev, [net], generator)
    epoch = [0]

    def run():
        epoch[0] += 1
        if generator is not None:
            generator.manual_seed(SEED + epoch[0])
        if mode == "a_parent_loop":
            # the parent's loop: NumPy packing and BFS, a blocking upload
            # from pageable memory, eager steps
            os.environ["GEOSSL_NO_NATIVE"] = "1"
            try:
                out = [common.optimizer_step(opt, sched, body,
                                             [b.to(dev)])[None]
                       for b in loader.epoch(epoch[0])]
            finally:
                del os.environ["GEOSSL_NO_NATIVE"]
        elif chain is None:
            out = [common.optimizer_step(opt, sched, body, [b])[None]
                   for b in prefetch(loader.epoch(epoch[0]), dev)]
        else:
            out = [chain(g) for g in common.accum_groups(
                prefetch(loader.epoch(epoch[0]), dev), HOST_K)]
        losses = torch.cat(out)
        torch.cuda.synchronize()
        if len(losses) != HOST_STEPS or not torch.isfinite(losses).all():
            fail(f"host_runtime {name} {mode}: {len(losses)} steps, "
                 f"losses {losses.tolist()}")
    return run


HOST_RUNTIME_PATHS = ("QM9-SchNet", "QM9-PaiNN", "MD17-SchNet", "MD17-PaiNN",
                      "DDM-SchNet", "DDM-PaiNN", "contextpred-SchNet",
                      "contextpred-PaiNN")


def host_runtime_path(dev, card, names=HOST_RUNTIME_PATHS):
    """The ``host_runtime:`` lines: per path and mode, step ms (median of 3
    untraced epochs of HOST_STEPS steps, after a warm-up epoch), device busy
    ms per step and the idle share of one traced epoch."""
    rows = []
    for name in names:
        state = host_path(dev, name)
        modes = {}
        for mode in HOST_MODES:
            run = host_epochs(dev, name, mode, state)
            t0 = time.perf_counter()
            run()  # warm-up: graph captures, pinned blocks, profiler
            first_s = time.perf_counter() - t0
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                runs.append((time.perf_counter() - t0) * 1e3 / HOST_STEPS)
            wall, busy, ours = device_profile(run)
            modes[mode] = {
                "step_ms": sorted(runs)[1], "step_ms_runs": runs,
                "first_epoch_s": first_s,
                "device_busy_ms": busy * 1e3 / HOST_STEPS,
                "traced_step_ms": wall * 1e3 / HOST_STEPS,
                "idle_share": 1.0 - busy / wall}
        row = {"path": name, "batch": 5 if name.startswith("MD17") else 128,
               "bucket": 32, "steps_per_epoch": HOST_STEPS, "k": HOST_K,
               "card": card, "modes": modes}
        print("host_runtime: " + json.dumps(row))
        rows.append(row)
    return rows


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def graph_parity_path(dev, cases=None, label="graph_parity"):
    """``graph_parity:``: per ported driver step and backbone (QM9, MD17,
    DDM with its device generator, LBA, LEP), two calls of HOST_K graph-replayed
    steps (``common.ChainStep``) against 2·HOST_K eager steps from the same
    state on the same batches through the same optimizer (Adam made
    capturable, as the graphs run it): the losses, all parameters together
    by relative norm GRAD_RTOL and each parameter by 10x that. The eager
    steps of the drivers' ``--steps_per_call 1`` path (Adam as constructed:
    the step size and bias corrections in f64 on the host, not in f32 on
    the device) run twice beside them: once against the graphs (losses and
    all parameters at GRAD_RTOL, each parameter reported), and once more
    for the kernels' own run-to-run spread; the graphs run twice too, for
    theirs (atomic sums, whose order varies with the launches' timing and
    which Adam amplifies in a parameter whose gradient is a sum of
    cancelling terms, as NCSN's biases are: one term of random sign per
    pair). A parameter beyond 10x GRAD_RTOL passes only within
    NOISE_FACTOR times the largest spread; while one is beyond that, more
    pairs of eager runs sample the spread, SPREAD_PAIRS eager pairs in all
    at most (a run can end in one of two states that one pair need not
    show: ``eager_pairs`` on the line)."""
    import torch

    from geossl_tpu_torch.data.bucketing import BucketedLoader
    from geossl_tpu_torch.data.synthetic import synthetic_lba, synthetic_lep
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.train import common, optim
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import finetune_lep as FE

    def side(name):
        task, model_3d = name.split("-")[:2]
        if task not in ("LBA", "LEP"):
            net, opt, sched, body, gen, make_loader = host_path(dev, name)
            return net, opt, sched, body, gen, make_loader(True)
        driver = FL if task == "LBA" else FE
        args = driver.build_parser().parse_args(
            ["--model_3d", model_3d.lower(), "--batch_size", "16"])
        net = driver.make_net(args, common.model_config_from_args(args),
                              torch.Generator().manual_seed(SEED)).to(dev)
        opt, sched = common.make_optimizer_from_args(
            args, net.parameters(), 2 * HOST_K)
        if task == "LBA":
            loader = BucketedLoader(synthetic_lba(16 * 2 * HOST_K, seed=2,
                                                  max_atoms=400),
                                    16, (512,), seed=SEED)
        else:
            loader = FE.DualLoader(*synthetic_lep(16 * 2 * HOST_K, seed=3),
                                   16, (512,), shuffle=True, seed=SEED)
        return (net, opt, sched, common.finetune_body(net, driver.loss_fn),
                None, loader)

    def flat(net):
        return torch.cat([p.detach().flatten() for p in net.parameters()])

    def compare(a, b):
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        per = {k: rel_norm(pb[k].detach(), pa[k].detach()) for k in pa}
        return per, rel_norm(flat(b), flat(a))

    def captured_kernels(name):
        """The launch counters that the graph side's captures must move: the
        backbone's training pair at bucket 32 (bf16: its bf16 instances)."""
        if name.split("-")[0] not in BASELINE_CASES_TASKS and \
                not name.endswith("-bf16"):
            return ()
        pair = PATH_KERNELS[name.split("-")[1].lower()]
        return tuple(f"{k}_bf16" for k in pair) if name.endswith("-bf16") \
            else pair

    rows = []
    cases = cases or GRAPH_PARITY_CASES
    for name in cases:
        t_case = time.time()
        same, plain_a, plain_b, graph, graph_b = (side(name)
                                                  for _ in range(5))
        optim.make_capturable(same[1])
        batches = [b.to(dev) for b in same[5].epoch(1)][:2 * HOST_K]
        if len(batches) != 2 * HOST_K:
            fail(f"graph_parity {name}: {len(batches)} batches")
        init = snapshot(same[0])
        losses = []
        for net, opt, sched, body, gen, _ in (same, plain_a, plain_b, graph,
                                              graph_b):
            net.load_state_dict(init)
            if gen is not None:
                gen.manual_seed(SEED + 11)
            if net in (graph[0], graph_b[0]):
                chain = common.ChainStep(opt, sched, body, dev, [net], gen)
                reset_launch_counts()
                out = [chain(batches[s:s + HOST_K])
                       for s in range(0, len(batches), HOST_K)]
                if net is graph[0]:
                    # the counters count captures: one graph of HOST_K
                    # steps, its warm-up step before it
                    captured = {k: v for k, v in launch_counts().items() if v}
            else:
                out = [common.optimizer_step(opt, sched, body, [b])[None]
                       for b in batches]
            losses.append(torch.cat(out).reshape(len(batches), -1)[:, 0])
        torch.cuda.synchronize()
        per, total = compare(same[0], graph[0])
        spread_e, spread_total = compare(plain_a[0], plain_b[0])
        spread_g, spread_total_g = compare(graph[0], graph_b[0])
        spread = {k: max(spread_e[k], spread_g[k]) for k in spread_e}
        per_plain, total_plain = compare(plain_a[0], graph[0])
        worst = max(per, key=per.get)
        worst_plain = max(per_plain, key=per_plain.get)
        # one eager pair can miss a parameter's spread: a run may end in one
        # of two states (NCSN_02.b2 of DDM-SchNet: 1.2e-2 apart or within
        # 2e-3, PERF.md), so a parameter beyond NOISE_FACTOR times the
        # sampled spread draws more eager pairs, SPREAD_PAIRS in all at most
        pairs = 1
        while pairs < SPREAD_PAIRS and any(
                per[k] > 10 * GRAD_RTOL and per[k] > NOISE_FACTOR * spread[k]
                for k in per):
            extra = []
            for net, opt, sched, body, gen, _ in (side(name), side(name)):
                net.load_state_dict(init)
                if gen is not None:
                    gen.manual_seed(SEED + 11)
                for b in batches:
                    common.optimizer_step(opt, sched, body, [b])
                extra.append(net)
            more, _ = compare(*extra)
            spread = {k: max(spread[k], more[k]) for k in spread}
            pairs += 1
        beyond = {k: [per[k], spread[k]] for k in per if per[k] > 10 * GRAD_RTOL}
        row = {"path": name, "steps": len(batches), "k": HOST_K,
               "loss_rel_norm": rel_norm(losses[3], losses[0]),
               "param_rel_norm": total, "worst_param": [worst, per[worst]],
               "beyond_10x_grad_rtol": beyond,
               "vs_plain_adam": {
                   "loss_rel_norm": rel_norm(losses[3], losses[1]),
                   "param_rel_norm": total_plain,
                   "worst_param": [worst_plain, per_plain[worst_plain],
                                   spread[worst_plain]]},
               "eager_spread": {"loss_rel_norm": rel_norm(losses[2], losses[1]),
                                "param_rel_norm": spread_total},
               "graph_spread": {"loss_rel_norm": rel_norm(losses[4], losses[3]),
                                "param_rel_norm": spread_total_g},
               "eager_pairs": pairs,
               "params_moved_rel_norm": rel_norm(
                   flat(same[0]), torch.cat([init[k].flatten()
                                             for k in dict(same[0].named_parameters())])),
               "losses_eager": losses[0].tolist()[:4],
               "losses_graphs": losses[3].tolist()[:4],
               "captured_launches": captured,
               "seconds": time.time() - t_case}
        print(f"{label}: " + json.dumps(row))
        for k in captured_kernels(name):
            if not captured.get(k):
                fail(f"{label} {name}: kernel {k} was not captured in its "
                     f"graphs ({captured})")
        bad = [k for k, (d, sp) in beyond.items() if d > NOISE_FACTOR * sp]
        if not torch.isfinite(losses[3]).all() \
                or row["loss_rel_norm"] > GRAD_RTOL or total > GRAD_RTOL \
                or bad or row["vs_plain_adam"]["loss_rel_norm"] > GRAD_RTOL \
                or total_plain > GRAD_RTOL:
            fail(f"{label} {name}: graph-replayed steps differ from "
                 f"eager steps (losses {row['loss_rel_norm']:.3e}, "
                 f"parameters {total:.3e}, beyond the eager spread: {bad}; "
                 f"against plain Adam: {row['vs_plain_adam']})")
        rows.append(row)
    return rows


# -- 3j. parallel -----------------------------------------------------------------

PAIR_STRIPE = 256  # each rank's j-stripe of the LBA grid (N=512, D=2)


def _nccl_world1(rank, port):
    """An NCCL process group of one rank on the card: ``graph_parity:``'s
    check of graph-replayed steps against eager steps for two paths, with
    the mesh's collectives in every step (the gradient all_reduce captured
    in each CUDA graph). Exits non-zero on a mismatch (``fail``)."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.parallel import mesh as pmesh
    from geossl_tpu_torch.parallel import multihost

    dev = torch.device("cuda", 0)
    K.plain_precision()
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=dev)
    mesh = pmesh.make_mesh(1, dev)
    if mesh is None or torch.distributed.get_backend() != "nccl":
        fail("parallel: no NCCL mesh of one rank")
    graph_parity_path(dev, ("QM9-PaiNN", "DDM-SchNet"),
                      label="parallel nccl_graph_parity")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, nprocs, *args):
    """``fn(rank, *args)`` in ``nprocs`` fresh processes (spawn), joined; a
    failed one ends the others and fails the run."""
    import torch

    try:
        torch.multiprocessing.start_processes(fn, args=args, nprocs=nprocs,
                                              join=True, start_method="spawn")
    except Exception as e:  # the child printed its own failure
        fail(f"parallel: {fn.__name__} failed ({type(e).__name__}: {e})")


PRETRAIN = "geossl_tpu_torch.train.pretrain_geossl"
FINETUNE_LBA = "geossl_tpu_torch.train.finetune_lba"
# (a): one full-width DDM-SchNet epoch of 2 steps at bucket 128
DDM_FLAGS = ["--synthetic", "--synthetic_size", "256", "--synthetic_max_atoms",
             "100", "--bucket", "128", "--batch_size", "128", "--epochs", "1",
             "--seed", str(SEED)]
# the launcher runs' flags: two gloo ranks sharing the card
TWO_GLOO = ["--dist_backend", "gloo"]
_LAUNCHED = []  # the launcher processes phase 3j started


def lba_flags(model_3d):
    """(b): one LBA step at B=64, N=512 (a train split of 64 of 80
    synthetic complexes), no weight decay."""
    return ["--model_3d", model_3d, "--synthetic", "--synthetic_size", "80",
            "--batch_size", "64", "--bucket", "512", "--epochs", "1",
            "--decay", "0", "--seed", str(SEED)]


def driver_start(module, tag, argv, launcher=False):
    """``module``'s ``main(argv)`` (a driver), writing into
    ``runs/chip_smoke_parallel_<tag>`` with a ``--log_file`` there: run to
    its end in this process, or (``launcher``) started as ``python -m
    <module>`` in a session of its own, whose launcher starts the ranks
    (``train/common.start_ranks``). Returns the job for
    :func:`driver_wait`."""
    import importlib

    out = os.path.join(ROOT, "runs", f"chip_smoke_parallel_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    argv = argv + ["--output_model_dir", out, "--log_file",
                   os.path.join(out, "log.jsonl")]
    t0, proc = time.time(), None
    if launcher:
        with open(os.path.join(out, "output.txt"), "w") as f:
            proc = subprocess.Popen([sys.executable, "-m", module, *argv],
                                    cwd=ROOT, stdout=f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        _LAUNCHED.append(proc)
    else:
        importlib.import_module(module).main(argv)
    return module, argv, proc, out, t0


def driver_wait(job):
    """(the log's first line, the output directory, the seconds since the
    job started) of a :func:`driver_start` job, once it has ended; fails
    the run if the launcher failed or ran 600 s."""
    module, argv, proc, out, t0 = job
    if proc is not None:
        try:
            rc = proc.wait(timeout=max(1.0, 600 - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            rc = "killed after 600 s"
        if rc != 0:
            with open(os.path.join(out, "output.txt")) as f:
                tail = f.read()[-4000:]
            fail(f"parallel: {module} {' '.join(argv)} exited {rc}: {tail}")
    seconds = time.time() - t0
    with open(os.path.join(out, "log.jsonl")) as f:
        return json.loads(f.readline()), out, seconds


def stop_launched():
    """End every launcher phase 3j started, with its ranks (each launcher
    leads a session of its own)."""
    import signal

    for proc in _LAUNCHED:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def ddm_two_ranks(two):
    """(a) ``two``: the job of ``pretrain_geossl --num_devices 2
    --dist_backend gloo`` (:func:`driver_start`: two gloo ranks sharing the
    card, the launcher's spawn) on DDM_FLAGS, held to two one-process runs
    of the same command line without ``--num_devices``: the epoch loss at
    RTOL, the backbone's parameters together by relative norm GRAD_RTOL,
    each beyond 10x that only within NOISE_FACTOR times the two one-process
    runs' own spread (the kernels' atomics)."""
    import torch

    def run(job):
        line, out, seconds = driver_wait(job)
        return line["loss"], torch.load(os.path.join(
            out, "model_final.pth"))["model"], seconds

    loss_a, a, _ = run(driver_start(PRETRAIN, "one_a", DDM_FLAGS))
    loss_b, b, _ = run(driver_start(PRETRAIN, "one_b", DDM_FLAGS))
    loss_2, two, seconds = run(two)
    per = {k: rel_norm(two[k].float(), a[k].float()) for k in a}
    spread = {k: rel_norm(b[k].float(), a[k].float()) for k in a}
    total = rel_norm(torch.cat([two[k].flatten() for k in a]).float(),
                     torch.cat([a[k].flatten() for k in a]).float())
    beyond = {k: [per[k], spread[k]] for k in per if per[k] > 10 * GRAD_RTOL}
    row = {"path": "DDM-SchNet two gloo ranks on one card", "steps": 2,
           "bucket": 128, "loss_one": loss_a, "loss_one_again": loss_b,
           "loss_two_ranks": loss_2, "param_rel_norm": total,
           "one_process_spread": rel_norm(
               torch.cat([b[k].flatten() for k in a]).float(),
               torch.cat([a[k].flatten() for k in a]).float()),
           "beyond_10x_grad_rtol": beyond, "two_rank_seconds": seconds,
           "two_rank_seconds_beside": "phase 3j's other launchers"}
    print("parallel ddm_two_ranks: " + json.dumps(row))
    bad = [k for k, (d, sp) in beyond.items() if d > NOISE_FACTOR * sp]
    if not abs(loss_2 - loss_a) <= RTOL * abs(loss_a) or total > GRAD_RTOL \
            or bad:
        fail(f"parallel: two ranks differ from one process (loss {loss_2} vs "
             f"{loss_a}, parameters {total:.3e}, beyond the spread: {bad})")


def lba_pair_step(dev, model_3d, pair):
    """(b) ``pair``: the job of ``finetune_lba --pair_devices 2
    --dist_backend gloo`` (:func:`driver_start`: two gloo ranks sharing the
    card on a (data 1, pair 2) mesh, the launcher's spawn) on
    ``lba_flags(model_3d)``: one full-width LBA step at B=64, N=512 whose
    stripes run the plain-mode pair kernels, held to the same command line
    in one process without ``--pair_devices`` (the symmetric routes) as
    ``check_step_parity`` holds a step: the epoch loss (its one step's) and
    the first step's gradients, read from each run's ``state.pth`` (Adam's
    first moment after one step is (1 - beta1) times the gradient). Returns
    rank 0's launches over the pair run (the log line's ``launches``: the
    step and both evaluations)."""
    import torch

    from geossl_tpu_torch.train import checkpoints, common
    from geossl_tpu_torch.train import finetune_lba as FL

    def first_step(job):
        line, out, seconds = driver_wait(job)
        opt = checkpoints.load_train_state(
            os.path.join(out, "state.pth"))[0]["opt"]
        group = opt["param_groups"][0]
        return line, [(opt["state"][i]["exp_avg"] / (1 - group["betas"][0]))
                      .to(dev) for i in group["params"]], seconds

    flags = lba_flags(model_3d)
    one, grads_one, _ = first_step(driver_start(
        FINETUNE_LBA, f"lba_{model_3d}_one", flags))
    two, grads_two, seconds = first_step(pair)
    # the parameters' names, in the order the driver gave them to Adam
    args = FL.build_parser().parse_args(flags)
    names = [n for n, _ in FL.make_net(
        args, common.model_config_from_args(args),
        torch.Generator().manual_seed(SEED)).named_parameters()]
    if len(names) != len(grads_one):
        fail(f"parallel: LBA-{model_3d}'s state.pth holds {len(grads_one)} "
             f"moments for {len(names)} parameters")
    print(f"parallel: finetune_lba --model_3d {model_3d} --pair_devices 2 "
          f"ran in {seconds:.1f} s (spawn and kernel loads included, beside "
          "phase 3j's other launchers)")
    check_step_parity(f"parallel pair step LBA-{model_3d} B=64 N=512 "
                      "(finetune_lba --pair_devices 2 vs one process)",
                      two["train_loss"], dict(zip(names, grads_two)),
                      one["train_loss"], dict(zip(names, grads_one)))
    used = two["launches"]
    print(f"parallel pair run LBA-{model_3d}: rank 0's launches {used}")
    want = ("cfconv_fwd", "cfconv_bwd") if model_3d == "schnet" else \
        ("painn_fwd", "painn_bwd")
    if any(not used.get(k) for k in want) or any(
            k.endswith("_sym") or "stack" in k for k in used):
        fail(f"parallel: the {model_3d} pair run launched {used}, not the "
             f"plain-mode pair {want} alone")
    return {k: used[k] for k in want}


def parallel_path(dev, card, errs, lba_batch, nets, G, cutoff, cut_p):
    """Phase 3j, ``parallel:``. (a) :func:`ddm_two_ranks`. (b)
    :func:`lba_pair_step` for each backbone; and the plain-mode kernels
    #1/#2 (``cfconv_fwd``, ``cfconv_bwd``) and #8/#9 (``painn_fwd``,
    ``painn_bwd``) held to their plain versions at the stripe shape
    [64, 512, 256] (block 0's inputs of ``nets`` on ``lba_batch``, each
    rank's stripe), timed there and on the whole grid (``stripe_kernels:``;
    a row's ``ms`` and ``bound_ms`` are its slower stripe's). (c)
    :func:`_nccl_world1`. Returns (the pair runs' launches per kernel, both
    backbones, from rank 0; each stripe kernel's row)."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import painn as P

    t_all = time.time()
    # the launchers first: they run beside the one-process runs
    jobs = {"ddm": driver_start(PRETRAIN, "two", DDM_FLAGS + [
        "--num_devices", "2"] + TWO_GLOO, launcher=True)}
    for model_3d in nets:
        jobs[model_3d] = driver_start(
            FINETUNE_LBA, f"lba_{model_3d}_pair", lba_flags(model_3d) + [
                "--pair_devices", "2"] + TWO_GLOO, launcher=True)
    pair_launches = {}
    try:
        ddm_two_ranks(jobs["ddm"])
        for model_3d in nets:
            pair_launches.update(lba_pair_step(dev, model_3d, jobs[model_3d]))
    finally:
        stop_launched()

    # the stripe kernels at [64, 512, 256] against their plain versions, on
    # each rank's stripe (a complex's atoms come first, its padding last:
    # the second stripe holds fewer real pairs)
    n = lba_batch.atom_type.shape[1]
    sp = K.sparse_auto(n, "auto")
    gen = torch.Generator(dev).manual_seed(SEED)
    with torch.no_grad():
        m = nets["schnet"].model
        dist, adj = m.geometry(lba_batch.positions, lba_batch.node_mask)
        env = m.envelope(dist, adj)
        blk = m.interactions[0]
        x = blk.conv.lin1(m.embedding(lba_batch.atom_type))
        fw = blk.filter_weights()
        mp = nets["painn"].model
        wk, bk = mp.filter_weights()[0]
    grids, q0, xp, mu = painn_inputs(mp, lba_batch)
    full = (dist.contiguous(), env.contiguous(), x.contiguous())
    full_p = (*grids, xp, mu)
    g = torch.randn((x.shape[0], n, x.shape[-1]), generator=gen, device=dev)
    gq = torch.randn(q0.shape, generator=gen, device=dev)
    gmu = torch.randn((xp.shape[0], n, xp.shape[-1]), generator=gen,
                      device=dev)
    F_ = x.shape[-1]
    wsize = G * F_ + 2 * F_ + F_ * F_
    flop_pair = 2 * G * F_ + 2 * F_ * F_ + 2 * F_
    R_, f3 = wk.shape
    whole = {
        "cfconv_fwd": lambda: K.cfconv_fused(*full, *fw, 0.0, cutoff, G, sp),
        "cfconv_bwd": lambda: K.cfconv_bwd(*full, g, *fw, 0.0, cutoff, G, sp),
        "painn_fwd": lambda: P.painn_message_fused(*full_p, wk, bk, cut_p, sp),
        "painn_bwd": lambda: P.painn_bwd(*full_p, wk, bk, gq, gmu, cut_p, sp)}
    stripe = {k: {"full_grid_shape": list(dist.shape), "sparse": sp,
                  "full_grid_ms": cuda_time_ms(fn),
                  "pair_launches": pair_launches.get(k, 0), "by_stripe": []}
              for k, fn in whole.items()}
    for j0 in range(0, n, PAIR_STRIPE):
        j = slice(j0, j0 + PAIR_STRIPE)
        ds, es, xs = (t.contiguous() for t in (dist[:, :, j], env[:, :, j],
                                                x[:, j]))
        gs = tuple(t[:, :, j].contiguous() for t in grids)
        xps, mus = xp[:, j].contiguous(), mu[:, j].contiguous()
        what = f"LBA stripe j={j0}:{j0 + ds.shape[-1]} {list(ds.shape)}"
        with torch.no_grad():
            want = chunked(K.cfconv_fused_reference, (ds, es, xs),
                           (*fw, 0.0, cutoff, G), 4)
            for s in (False, True):
                errs.check("cfconv_fwd", K.cfconv_fused(
                    ds, es, xs, *fw, 0.0, cutoff, G, s), want,
                    f"{what} sparse={s}")
            want = chunked(lambda *a: torch.cat(P.painn_message_reference(
                *a, wk, bk, cut_p), dim=-1), (*gs, xps, mus), (), 4)
            for s in (False, True):
                errs.check("painn_fwd", torch.cat(P.painn_message_fused(
                    *gs, xps, mus, wk, bk, cut_p, s), dim=-1), want,
                    f"{what} sparse={s}")
        check_cfconv_bwd(errs, ds, es, xs, g, fw, G, cutoff, what, chunk=4)
        check_painn_bwd(errs, gs, xps, mus, wk, bk, gq, gmu, cut_p, what,
                        chunk=2)
        nnz, filt_pairs, cells, tiles = pair_work(ds, es)
        nnz_p, filt_p, cells_p, tiles_p = pair_work(gs[0], gs[1])
        rows = {
            "cfconv_fwd": (
                lambda: K.cfconv_fused(ds, es, xs, *fw, 0.0, cutoff, G, sp),
                lambda: chunked(K.cfconv_fused_reference, (ds, es, xs),
                                (*fw, 0.0, cutoff, G), 4),
                (filt_pairs * (flop_pair - 2 * F_), nnz * 2 * F_),
                # env read, dist on its occupied tiles, x read, the
                # messages written, the filter weights
                4 * (cells + tiles + xs.numel() + g.numel() + wsize)),
            "cfconv_bwd": (
                lambda: K.cfconv_bwd(ds, es, xs, g, *fw, 0.0, cutoff, G, sp),
                lambda: chunked_sum(K.cfconv_bwd_reference, (ds, es, xs, g),
                                    (*fw, 0.0, cutoff, G), 4, 3),
                (filt_pairs * (2 * G * F_ + 2 * F_ * F_)
                 + nnz * (4 * F_ * F_ + 4 * G * F_), nnz * 6 * F_),
                # as the forward, and ddist/denv written, g read, dx
                # written, the weight gradients written
                4 * (cells + tiles + 2 * ds.numel() + 2 * xs.numel()
                     + g.numel() + 2 * wsize)),
            "painn_fwd": (
                lambda: P.painn_message_fused(*gs, xps, mus, wk, bk, cut_p,
                                              sp),
                lambda: chunked(lambda *a: torch.cat(
                    P.painn_message_reference(*a, wk, bk, cut_p), dim=-1),
                    (*gs, xps, mus), (), 4),
                # the filter per needed pair on the tensor cores; gating
                # and the message sums (~8F per ordered pair) on the CUDA
                # cores
                (filt_p * 2 * R_ * f3, nnz_p * 8 * (f3 // 3)),
                # the gate whole, dist and the directions on its occupied
                # tiles, x and mu read, dq and dmu written
                4 * (cells_p + 4 * tiles_p + xps.numel() + mus.numel()
                     + gq.numel() + gmu.numel() + (R_ + 1) * f3)),
            "painn_bwd": (
                lambda: P.painn_bwd(*gs, xps, mus, wk, bk, gq, gmu, cut_p,
                                    sp),
                lambda: chunked_sum(
                    lambda d, gt, a, b_, c, xx, mm, gq_, gmu_:
                    P.painn_bwd_reference(d, gt, a, b_, c, xx, mm, wk, bk,
                                          gq_, gmu_, cut_p),
                    (*gs, xps, mus, gq, gmu), (), 2, 7),
                (filt_p * (2 * R_ * f3 + 2 * (R_ + 1) * f3)
                 + nnz_p * 2 * R_ * f3, nnz_p * 40 * (f3 // 3)),
                4 * (cells_p + 4 * tiles_p + 5 * gs[0].numel()
                     + 2 * xps.numel() + 2 * mus.numel() + gq.numel()
                     + gmu.numel() + 2 * (R_ + 1) * f3)),
        }
        for name, (fn, plain, flops, nbytes) in rows.items():
            t_ops = max(flops[0] / PEAK_TF32_FLOPS,
                        flops[1] / PEAK_F32_FLOPS) * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            with torch.no_grad():
                stripe[name]["by_stripe"].append({
                    "j": [j0, j0 + ds.shape[-1]], "shape": list(ds.shape),
                    "ms": cuda_time_ms(fn),
                    "plain_ms": cuda_time_ms(plain, reps=2, warmup=1),
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    for row in stripe.values():
        # the row's shape: the slower stripe's (the pair step waits for it)
        row.update(max(row["by_stripe"], key=lambda r: r["ms"]))
    print("stripe_kernels: " + json.dumps(stripe))

    # (c) NCCL at world size 1: graph-replayed steps with the collectives
    t0 = time.time()
    spawn(_nccl_world1, 1, free_port())
    print(f"parallel: NCCL world 1 graph parity in {time.time() - t0:.1f} s")
    print(f"parallel: phase 3j in {time.time() - t_all:.1f} s")
    return pair_launches, stripe


# -- 3k. tools ---------------------------------------------------------------------
# the synthetic Molecule3D raw corpus of (b): molecules, their atom range and
# the unparseable-block period (each keeps its properties row)
M3D_RAW = dict(num_molecules=2048, min_atoms=4, max_atoms=100, bad_every=17)
M3D_SUBSET = 1024
TOOLS_BUDGET_S = 120.0


def front_door(*argv, timeout=300):
    """``python -m geossl_tpu_torch <argv>`` in a subprocess from the repo
    root: (rc, stdout, seconds); its output is echoed."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "geossl_tpu_torch", *argv],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    seconds = time.time() - t0
    for line in (r.stdout + r.stderr).splitlines():
        print(f"  | {line}")
    return r.returncode, r.stdout, seconds


def doctor_check():
    """(a): the doctor on the card, every kernel checked."""
    from geossl_tpu_torch.ops._launch import launch_counts

    rc, out, seconds = front_door("doctor", "--json", "--mesh", "2")
    lines = out.strip().splitlines()
    try:
        summary = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"tools: the doctor printed no JSON summary (rc {rc})")
    kernels = summary.get("kernels", {})
    checked = {c["name"]: c for c in kernels.get("checked", [])}
    if rc != 0 or not summary.get("ok") or \
            summary.get("backend", {}).get("platform") != "cuda":
        fail(f"tools: doctor rc {rc}, ok {summary.get('ok')}, backend "
             f"{summary.get('backend')}")
    missing = sorted(set(launch_counts()) - set(checked))
    if missing or kernels.get("mode") != "cuda" or \
            not all(c["ok"] and c["launches"] > 0 for c in checked.values()):
        fail(f"tools: the doctor did not check every kernel on the card "
             f"(missing {missing}, mode {kernels.get('mode')})")
    worst = max(checked.values(), key=lambda c: c["max_abs_err"])
    print("doctor: " + json.dumps({
        "seconds": seconds, "rc": rc, "kernels_checked": len(checked),
        "worst_kernel": worst["name"], "worst_max_abs_err": worst["max_abs_err"],
        "build": summary.get("build"), "dispatch": summary.get("dispatch"),
        "mesh": summary.get("mesh")}))
    return seconds


def molecule3d_check():
    """(b): the port builds the corpus from raw shards, DDM trains on it."""
    import math

    import numpy as np
    import torch

    from geossl_tpu_torch.data.store import MolStore
    from geossl_tpu_torch.data.synthetic import write_synthetic_molecule3d_raw
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.train import pretrain_geossl as PG

    root = os.path.join(ROOT, "runs", "chip_smoke_molecule3d")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    write_synthetic_molecule3d_raw(root, seed=SEED, **M3D_RAW)
    write_s = time.time() - t0
    rc, _, build_s = front_door("data", "molecule3d", "--root", root,
                                "--subset", str(M3D_SUBSET))
    cache = os.path.join(root, "processed",
                         f"molecule3d_{M3D_SUBSET}_store.npz")
    if rc != 0 or not os.path.exists(cache):
        fail(f"tools: data molecule3d exited {rc}, cache {cache}")
    store = MolStore.load(cache)
    sizes = store.num_atoms()
    if len(store) != M3D_SUBSET or not np.isfinite(store.y).all() or \
            sizes.min() < M3D_RAW["min_atoms"] or \
            sizes.max() > M3D_RAW["max_atoms"]:
        fail(f"tools: the built cache holds {len(store)} molecules of "
             f"{sizes.min()}-{sizes.max()} atoms")
    out = os.path.join(ROOT, "runs", "chip_smoke_molecule3d_ddm")
    shutil.rmtree(out, ignore_errors=True)
    reset_launch_counts()
    t0 = time.time()
    _, losses = PG.main(["--GeoSSL_option", "DDM", "--dataset",
                         f"Molecule3D_{M3D_SUBSET}", "--data_root", root,
                         "--epochs", "1", "--output_model_dir", out])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = launch_counts()
    for name in ("cfconv_fwd_sym", "cfconv_bwd_sym", "ncsn_score_fwd",
                 "ncsn_score_bwd"):
        if launches[name] == 0:
            fail(f"tools: {name} did not launch on DDM over the built "
                 "Molecule3D cache")
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"tools: DDM losses over the built cache {losses}")
    print("molecule3d: " + json.dumps({
        "raw_molecules": M3D_RAW["num_molecules"],
        "bad_every": M3D_RAW["bad_every"], "subset": M3D_SUBSET,
        "write_raw_s": write_s, "build_s": build_s,
        "ddm_steps": len(losses), "ddm_epoch_s": train_s,
        "launches": {k: v for k, v in launches.items() if v}}))
    return write_s + build_s + train_s


def evalkit_check(pretrained):
    """(c): one cell per family from the DDM-SchNet model.pth, then a
    resumed call that runs nothing."""
    import math

    import torch

    from geossl_tpu_torch import evalkit
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts

    out = os.path.join(ROOT, "runs", "chip_smoke_evalkit")
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--input_model_file", pretrained, "--out_dir", out, "--budget",
            "smoke", "--qm9_tasks", "mu", "--md17_tasks", "aspirin",
            "--atom3d_seeds", "42"]
    reset_launch_counts()
    t0 = time.time()
    results = evalkit.main(argv)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    first_launches = {k: v for k, v in launch_counts().items() if v}
    cells = ("qm9/mu", "md17/aspirin", "lba/seed42", "lep/seed42")
    for key in cells:
        vals = list(results.get(key, {}).values())
        if not vals or not all(math.isfinite(v) for v in vals):
            fail(f"tools: evalkit cell {key} = {results.get(key)}")
    reset_launch_counts()
    t0 = time.time()
    again = evalkit.main(argv)
    second_s = time.time() - t0
    relaunched = {k: v for k, v in launch_counts().items() if v}
    if again != results or second_s >= 10.0 or relaunched:
        fail(f"tools: the evalkit rerun took {second_s:.2f} s, launched "
             f"{relaunched} or changed the results")
    print("evalkit: " + json.dumps({
        "first_s": first_s, "rerun_s": second_s, "launches": first_launches,
        "cells": {k: results[k] for k in cells}}))
    return first_s + second_s


def flops_check(dev, batch):
    """(d): one DDM step per backbone at bucket 128, its device-busy ms
    with the analytic counts."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.utils import flops

    t_all = time.time()
    for model_3d in ("schnet", "painn"):
        targs = PG.build_parser().parse_args(["--model_3d", model_3d])
        ddm = PG.make_ddm(targs, common.model_config_from_args(targs),
                          torch.Generator().manual_seed(SEED)).to(dev)
        opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(),
                                                     100)
        gen = torch.Generator(dev).manual_seed(SEED)
        with torch.no_grad():
            pos2, sel = PG.batch_views(targs, batch, gen)
            fracs = []
            for pos in (batch.positions, pos2):
                if model_3d == "schnet":
                    dist, adj = ddm.model.geometry(pos, batch.node_mask)
                    grid = ddm.model.envelope(dist, adj)
                else:
                    grid = ddm.model.geometry(pos, batch.node_mask)[2]
                fracs.append(flops.executed_pair_fraction(grid, model_3d,
                                                          symmetric=True))
            pair_frac = sum(fracs) / len(fracs)
            head_frac = flops.executed_pair_fraction(sel, "ncsn")

        def step():
            PG.train_step(ddm, opt, sched, [batch], targs, gen)

        step()  # warm-up
        device_profile(step)  # the profiler's start-up
        wall, busy, ours = device_profile(step)
        b, n = batch.batch_size, batch.max_atoms
        dense = flops.ddm_step(b, n, model=model_3d).total
        executed = flops.ddm_step(b, n, model=model_3d, pair_frac=pair_frac,
                                  head_pair_frac=head_frac).total
        dense_tf, _ = flops.mfu(dense, busy)
        exec_tf, share = flops.mfu(executed, busy)
        print("flops: " + json.dumps({
            "model": model_3d, "bucket": n, "batch": b,
            "device_busy_ms": busy * 1e3, "traced_wall_ms": wall * 1e3,
            "dense_flop": dense, "executed_flop": executed,
            "pair_frac": pair_frac, "head_pair_frac": head_frac,
            "dense_effective_tflops": dense_tf, "executed_tflops": exec_tf,
            "executed_share_tf32": share, "peak": flops.H100_CARD}))
        if not 0.0 < share <= 1.0:
            fail(f"tools: {model_3d} DDM executed share of the TF32 peak "
                 f"{share:.3f} is not in (0, 1]")
    return time.time() - t_all


def se3_basis_check(dev):
    """(e): get_basis on the card in f32 against the CPU in f64."""
    import torch

    from geossl_tpu_torch.ops import se3_basis

    t0 = time.time()
    vec = torch.randn((4096, 3), generator=torch.Generator().manual_seed(SEED),
                      dtype=torch.float64)
    vec[0] = 0.0  # a self-pair
    want = se3_basis.get_basis(vec, 2)
    got = se3_basis.get_basis(vec.to(dev, torch.float32), 2)
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if g.device.type != "cuda" or g.dtype != torch.float32 or \
                g.shape != w.shape:
            fail(f"tools: se3_basis {key}: {g.device} {g.dtype} {g.shape}")
        rel = ((g.cpu().double() - w).abs().max() / w.abs().max()).item()
        worst = max(worst, rel)
    if not worst <= 1e-5:
        fail(f"tools: se3_basis f32 on the card vs f64 max relative error "
             f"{worst:.3e} > 1e-5")
    print("se3_basis: " + json.dumps({"keys": len(want), "vectors": len(vec),
                                      "max_rel_err": worst}))
    return time.time() - t0


def tools_path(dev, card, pretrained, batch128):
    """Phase 3k: the doctor, the Molecule3D build and DDM on it, evalkit,
    the flops shares and se3_basis, within TOOLS_BUDGET_S."""
    t0 = time.time()
    parts = {"doctor": doctor_check(), "molecule3d": molecule3d_check(),
             "evalkit": evalkit_check(pretrained),
             "flops": flops_check(dev, batch128),
             "se3_basis": se3_basis_check(dev)}
    total = time.time() - t0
    print("tools: " + json.dumps({"seconds": total, "parts_s": parts,
                                  "card": card}))
    if total > TOOLS_BUDGET_S:
        fail(f"tools: phase 3k took {total:.1f} s, above its "
             f"{TOOLS_BUDGET_S:.0f} s")


def profile_dir_check(dev):
    """``profile_dir:``: one ``pretrain_geossl --profile_dir`` epoch on a cut
    store (256 molecules) at full width; the trace must exist and not be
    empty."""
    import contextlib
    import io

    from geossl_tpu_torch.train import pretrain_geossl as PG

    trace_dir = os.path.join(ROOT, "runs", "chip_smoke_profile")
    shutil.rmtree(trace_dir, ignore_errors=True)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        PG.main(["--synthetic", "--synthetic_size", "256", "--epochs", "1",
                 "--device", str(dev), "--profile_dir", trace_dir,
                 "--steps_per_call", str(HOST_K)])
    path = os.path.join(trace_dir, "trace.json")
    said = f"profiler trace written to {trace_dir}" in out.getvalue()
    size = os.path.getsize(path) if os.path.exists(path) else 0
    print("profile_dir: " + json.dumps({"trace": path, "bytes": size,
                                         "printed": said,
                                         "s": time.time() - t0}))
    if not size or not said:
        fail(f"profile_dir: no trace at {path} ({size} bytes; printed "
             f"{said})")


# -- 5. any --num_gaussians ------------------------------------------------------
# The Gaussian counts the phase holds the CFConv kernels at (above 64 they
# stream W1), and those whose rows join the kernel table
GAUSS_G = (65, 100, 300)
GAUSS_ROWS = (100, 300)
GAUSS_BUDGET_S = 150.0
# kernel -> (source, the TPU kernel it replaces)
GAUSS_KERNELS = {
    "cfconv_fwd": ("geossl_tpu_torch/ops/csrc/cfconv_fwd.cu",
                   "geossl_tpu/ops/cfconv_pallas.py:92"),
    "cfconv_bwd": ("geossl_tpu_torch/ops/csrc/cfconv_bwd.cu",
                   "geossl_tpu/ops/cfconv_pallas.py:150"),
    "cfconv_fwd_sym": ("geossl_tpu_torch/ops/csrc/cfconv_fwd.cu",
                       "geossl_tpu/ops/cfconv_pallas.py:382"),
    "cfconv_bwd_sym": ("geossl_tpu_torch/ops/csrc/cfconv_bwd.cu",
                       "geossl_tpu/ops/cfconv_pallas.py:464"),
    "schnet_stack": ("geossl_tpu_torch/ops/csrc/schnet_stack.cu",
                     "geossl_tpu/ops/cfconv_pallas.py:712"),
}


def schnet_at(cfg, g, max_neighbors=None):
    """``cfg`` with ``g`` Gaussians (and ``max_neighbors``)."""
    import dataclasses

    return dataclasses.replace(
        cfg, max_neighbors=max_neighbors,
        schnet=dataclasses.replace(cfg.schnet, num_gaussians=g))


def gaussians_main_path(dev, g, store, buckets, first, layer0_inputs):
    """SchNet's paths at ``g`` Gaussians, full width (F=128, 6 blocks,
    cutoff 10), with the launch counters reset before and read after: a
    DDM epoch of ``pretrain_geossl --num_gaussians g`` (buckets 32/64/128,
    batch 128) on 256 molecules and one with ``--max_num_neighbors 32``,
    one LBA step at N=512 (``finetune_lba``, batch 64 of 80 complexes), and
    a seeded ``Predictor`` (and its ``max_neighbors=32`` twin) serving the
    store over buckets 32..512, held to the plain path on 8 molecules per
    bucket (rtol 1e-4, atol 1e-5 x max). Every kernel of #1-#5 must launch.
    Returns the counts."""
    import math

    import numpy as np
    import torch

    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone, make_head

    flags = ["--num_gaussians", str(g)]
    cfg = schnet_at(ModelConfig(), g)
    gen = torch.Generator().manual_seed(SEED)
    state = {"model": make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": make_head("schnet", cfg.emb_dim,
                                            gen).state_dict(),
             "y_mean": 1.5, "y_std": 2.0}
    preds = {"default": Predictor(cfg, state, batch_size=128,
                                  bucket_sizes=buckets),
             "max_neighbors=32": Predictor(schnet_at(cfg, g, 32), state,
                                           batch_size=128,
                                           bucket_sizes=buckets)}
    reset_launch_counts()
    t0 = time.time()
    steps = []
    for extra in ([], ["--max_num_neighbors", "32"]):
        run_dir = os.path.join(ROOT, "runs", f"chip_smoke_g{g}")
        shutil.rmtree(run_dir, ignore_errors=True)
        _, losses = PG.main(["--synthetic", "--synthetic_size", "256",
                             "--synthetic_max_atoms", "100", "--epochs", "1",
                             "--output_model_dir", run_dir, *flags, *extra])
        steps.append(len(losses))
        if not losses or not all(math.isfinite(v) for v in losses):
            fail(f"pretrain_geossl G={g} {extra}: losses {losses}")
    run_dir = os.path.join(ROOT, "runs", f"chip_smoke_g{g}_lba")
    shutil.rmtree(run_dir, ignore_errors=True)
    _, best, _, losses = FL.main(["--synthetic", "--synthetic_size", "80",
                                  "--epochs", "1", "--output_model_dir",
                                  run_dir, *flags])
    if not losses or not all(math.isfinite(v) for v in losses) or \
            not math.isfinite(best):
        fail(f"finetune_lba G={g}: losses {losses}, best val {best}")
    got = {what: p.predict(store) for what, p in preds.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"gaussians main path G={g}: DDM {steps[0]} steps, max_neighbors "
          f"{steps[1]} steps, LBA {len(losses)} step(s), {len(store)} "
          f"molecules served twice in {time.time() - t0:.2f} s; launches "
          f"{counts}")
    for name in GAUSS_KERNELS:
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the G={g} paths")
    with torch.inference_mode():
        for what, p in preds.items():
            if not np.isfinite(got[what]).all():
                fail(f"Predictor G={g} {what}: non-finite output")
            for b in buckets:
                idx = first(b, 8)
                batch, *_ = layer0_inputs(p.model, idx, b)
                graph, _ = p.model(batch.atom_type, batch.positions,
                                   batch.node_mask, plain=True)
                want = (p.head(graph) * p.y_std + p.y_mean).cpu().numpy()
                atol = ATOL * max(1.0, float(np.abs(want).max()))
                if not np.allclose(got[what][idx], want, rtol=RTOL, atol=atol):
                    fail(f"Predictor G={g} {what} bucket {b}: kernel path vs "
                         f"plain path, max_abs_err "
                         f"{np.abs(got[what][idx] - want).max():.3e}")
        print(f"gaussians serve parity G={g}: buckets {list(buckets)} agree "
              "with the plain path (default and max_neighbors=32)")
    return counts


def gaussians_kernels(dev, errs, g, cases, cfg, cutoff, timed, tag=None):
    """#1-#5 at ``g`` Gaussians on the shapes of their paths, each against
    its plain version (chunked), gating off and on, a second launch against
    the first (bitwise where the kernel writes each output once, as at
    G=51: #1, all of #2, and #4 but dx; #3 and #5 add with atomics: within
    the tolerance). Checks are recorded as ``<kernel><tag>`` (by default
    ``_g<g>``). With ``timed``: the rows (name, source, replaces, ms,
    plain_ms, flops, bytes) of the kernel table, bounds counted as the G=51
    rows'. The filter width is ``cfg``'s (``cases`` at that width); #5 only
    where the stack takes it (F <= 128)."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.train.common import make_backbone

    F_ = cfg.schnet.num_filters
    m = make_backbone(schnet_at(cfg, g),
                      torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        fw = [t.contiguous() for t in m.interactions[0].filter_weights()]
        stacked = m.stacked_weights()
    args = (0.0, cutoff, g)
    flop_pair = 2 * g * F_ + 2 * F_ * F_ + 2 * F_
    wsize = g * F_ + 2 * F_ + F_ * F_
    tag = f"_g{g}" if tag is None else tag
    rows = []

    def row(kernel, ms, plain_ms, flops, nbytes, **extra):
        src, replaces = GAUSS_KERNELS[kernel]
        rows.append((kernel + tag, src, replaces, ms, plain_ms, flops, nbytes,
                     extra))

    def same(name, a, b, what):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            fail(f"{name}{tag} {what}: outputs differ between two launches")

    # #1: serving's N=256 (max_neighbors=32 graph) and the DDM
    # max_num_neighbors batch at N=128
    with torch.no_grad():
        for what, (d, e, x) in (("serving B=128 N=256", cases["serve256"]),
                                ("DDM max_neighbors=32 B=128 N=128",
                                 cases["ddm_mn"][:3])):
            want = chunked(K.cfconv_fused_reference, (d, e, x), (*fw, *args), 4)
            for sp in (False, True):
                got = K.cfconv_fused(d, e, x, *fw, *args, sp)
                errs.check("cfconv_fwd" + tag, got, want, f"{what} sparse={sp}")
                same("cfconv_fwd", [got], [K.cfconv_fused(d, e, x, *fw, *args,
                                                          sp)], what)
        if timed:
            times = {}
            for what, (d, e, x) in (("serve", cases["serve256"]),
                                    ("ddm", cases["ddm_mn"][:3])):
                nnz, filt, cells, tiles = pair_work(d, e)
                times[what] = (
                    cuda_time_ms(lambda: K.cfconv_fused(d, e, x, *fw, *args,
                                                        True)),
                    cuda_time_ms(lambda: chunked(K.cfconv_fused_reference,
                                                 (d, e, x), (*fw, *args), 4),
                                 reps=3, warmup=1),
                    (filt * (flop_pair - 2 * F_), nnz * 2 * F_),
                    4 * (cells + tiles + 2 * x.numel() + sum(t.numel()
                                                             for t in fw)))
            ms, plain_ms, flops, nbytes = times["serve"]
            row("cfconv_fwd", ms, plain_ms, flops, nbytes,
                shape="serving B=128 N=256", ddm_shape=
                "DDM max_neighbors=32 B=128 N=128", ddm_ms=times["ddm"][0],
                ddm_plain_ms=times["ddm"][1], ddm_bound_ms=bound_ms(
                    times["ddm"][2], times["ddm"][3]))
    # #2 on the DDM max_num_neighbors batch
    d, e, x, gr = cases["ddm_mn"]
    first_ = check_cfconv_bwd(errs, d, e, x, gr, fw, g, cutoff,
                              "DDM max_neighbors=32 B=128 N=128", chunk=4,
                              name="cfconv_bwd" + tag)
    same("cfconv_bwd", first_, K.cfconv_bwd(d, e, x, gr, *fw, *args, True),
         "DDM max_neighbors=32")
    if timed:
        nnz, filt, cells, tiles = pair_work(d, e)
        row("cfconv_bwd",
            cuda_time_ms(lambda: K.cfconv_bwd(d, e, x, gr, *fw, *args, True)),
            cuda_time_ms(lambda: chunked_sum(
                K.cfconv_bwd_reference, (d, e, x, gr), (*fw, *args), 4, 3),
                reps=3, warmup=1),
            (filt * (2 * g * F_ + 2 * F_ * F_) + nnz * (4 * F_ * F_ + 4 * g * F_),
             nnz * 6 * F_),
            4 * (cells + tiles + 2 * d.numel() + 3 * x.numel() + 2 * wsize),
            shape="DDM max_neighbors=32 B=128 N=128")
    # #3 on the DDM batch (symmetric graph)
    d, e, x, gr = cases["ddm"]
    with torch.no_grad():
        want = chunked(K.cfconv_fused_reference, (d, e, x), (*fw, *args), 16)
        for sp in (False, True):
            got = K.cfconv_fused_sym(d, e, x, *fw, *args, sp)
            errs.check("cfconv_fwd_sym" + tag, got, want,
                       f"DDM B=128 N=128 sparse={sp}")
            errs.check("cfconv_fwd_sym" + tag, K.cfconv_fused_sym(
                d, e, x, *fw, *args, sp), got,
                f"DDM B=128 N=128 sparse={sp} second launch")
        if timed:
            nnz, filt, cells, tiles = pair_work(d, e)
            row("cfconv_fwd_sym",
                cuda_time_ms(lambda: K.cfconv_fused_sym(d, e, x, *fw, *args,
                                                        True)),
                cuda_time_ms(lambda: chunked(K.cfconv_fused_reference,
                                             (d, e, x), (*fw, *args), 16),
                             reps=3, warmup=1),
                (filt * (flop_pair - 2 * F_), nnz * 2 * F_),
                4 * (cells + tiles + 2 * x.numel() + sum(t.numel() for t in fw)),
                shape="DDM B=128 N=128")
    # #4 at the LBA shape
    d, e, x, gr = cases["lba"]
    first_ = check_cfconv_bwd_sym(errs, d, e, x, gr, fw, g, cutoff,
                                  "LBA B=64 N=512", chunk=4,
                                  name="cfconv_bwd_sym" + tag)
    again = K.cfconv_bwd_sym(d, e, x, gr, *fw, *args, True)
    # dx is added with atomics (the G=51 rows' contract): the rest bitwise
    same("cfconv_bwd_sym", first_[:2] + first_[3:], again[:2] + again[3:],
         "LBA (all but dx)")
    errs.check_scaled("cfconv_bwd_sym" + tag, again[2], first_[2],
                      "LBA B=64 N=512 dx second launch")
    if timed:
        nnz, filt, cells, tiles = pair_work(d, e)
        row("cfconv_bwd_sym",
            cuda_time_ms(lambda: K.cfconv_bwd_sym(d, e, x, gr, *fw, *args,
                                                  True)),
            cuda_time_ms(lambda: chunked_sum(
                K.cfconv_bwd_sym_reference, (d, e, x, gr), (*fw, *args), 4, 3),
                reps=3, warmup=1),
            (filt * (6 * g * F_ + 6 * F_ * F_), nnz * 6 * F_),
            4 * (cells + tiles + 2 * d.numel() + 3 * x.numel() + 2 * wsize),
            shape="LBA B=64 N=512")
    if F_ > K.KERNEL_F:  # the stack pads up to 128 and refuses wider
        return rows
    # #5 at serving's N=128 batch, both modes
    with torch.no_grad():
        for sym, key in ((True, "serve128"), (False, "serve128_mn")):
            d, e, h0 = cases[key]
            what = f"serving B=128 N=128 symmetric={sym}"
            want = chunked(K.schnet_stack_reference, (d, e, h0),
                           (stacked, *args), 32)
            got = K.schnet_stack(d, e, h0, stacked, *args, sym)
            errs.check("schnet_stack" + tag, got, want, what)
            errs.check("schnet_stack" + tag, K.schnet_stack(
                d, e, h0, stacked, *args, sym), got, f"{what} second launch")
        if timed:
            d, e, h0 = cases["serve128"]
            nnz, filt, cells, tiles = pair_work(d, e)
            atoms = cases["serve128_atoms"]
            layers = stacked[0].shape[0]
            row("schnet_stack",
                cuda_time_ms(lambda: K.schnet_stack(d, e, h0, stacked, *args,
                                                    True)),
                cuda_time_ms(lambda: chunked(
                    K.schnet_stack_reference, (d, e, h0), (stacked, *args), 32),
                    reps=3, warmup=1),
                (layers * (filt * (flop_pair - 2 * F_)
                           + atoms * 3 * 2 * F_ * F_),
                 layers * nnz * 2 * F_),
                4 * (cells + tiles + 2 * h0.numel()
                     + sum(t.numel() for t in stacked)),
                shape="serving B=128 N=128")
    return rows


def bound_ms(flops, nbytes, peak_tc=PEAK_TF32_FLOPS):
    """The bound of a (tensor-core, elementwise) operation count and a byte
    count, in ms: products at the tensor cores' peak (TF32, or bf16 for the
    bf16 instances) and elementwise terms at the f32 peak (the two units at
    once), bytes at the HBM rate."""
    return max(flops[0] / peak_tc, flops[1] / PEAK_F32_FLOPS,
               nbytes / PEAK_BYTES) * 1e3


def gaussians_ddm_step(dev, g, cfg, batch):
    """One full-width DDM-SchNet step at ``g`` Gaussians on ``batch``
    (bucket 128, a freshly seeded module) held to the plain step (relative
    norm 1e-3, ``step_parity``), then its device-busy ms over one traced
    step after a warm-up. Returns (device ms, port-kernel ms)."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    targs = PG.build_parser().parse_args(["--num_gaussians", str(g)])
    ddm = PG.make_ddm(targs, schnet_at(cfg, g),
                      torch.Generator().manual_seed(SEED)).to(dev)
    step_parity(ddm, batch, targs, 128, f"SchNet G={g}")
    opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(), 100)
    gen = torch.Generator(dev).manual_seed(SEED)

    def step():
        return PG.train_step(ddm, opt, sched, [batch], targs, gen)

    step()
    torch.cuda.synchronize()
    _, busy, ours = device_profile(step)
    return busy * 1e3, ours * 1e3


def gaussians_path(dev, card, errs, cfg, cutoff, cases, store, buckets, first,
                   layer0_inputs, ddm_batch):
    """Phase 5: the CFConv kernels at G = 65, 100 and 300. The main paths at
    G = 100 and 300 (their launches are the rows' counts), then each kernel
    at its path's shapes against its plain version, timed at G = 100 and
    300, and one DDM step at G = 300 against the plain step and beside the
    G = 51 step's device ms. Returns the kernel table's g-rows, with their
    launches."""
    t0 = time.time()
    launches = {g: gaussians_main_path(dev, g, store, buckets, first,
                                       layer0_inputs) for g in GAUSS_ROWS}
    rows = []
    for g in GAUSS_G:
        for name, src, replaces, ms, plain_ms, flops, nbytes, extra in \
                gaussians_kernels(dev, errs, g, cases, cfg, cutoff,
                                  g in GAUSS_ROWS):
            base = name.rsplit("_g", 1)[0]
            rows.append((name, src, replaces, ms, plain_ms, flops, nbytes,
                         launches[g][base], extra))
    step = {g: gaussians_ddm_step(dev, g, cfg, ddm_batch) for g in (300, 51)}
    seconds = time.time() - t0
    print("gaussians: " + json.dumps({
        "card": card, "seconds": seconds,
        "ddm_step_bucket_128": {f"G={g}": {"device_ms": busy,
                                           "port_kernels_ms": ours}
                                for g, (busy, ours) in step.items()},
        "rows": {name: {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(flops, nbytes), **extra}
                 for name, _, _, ms, plain_ms, flops, nbytes, _, extra
                 in rows}}))
    if seconds > GAUSS_BUDGET_S:
        fail(f"gaussians: {seconds:.1f} s, above its {GAUSS_BUDGET_S:.0f} s")
    return rows


# -- 6. the bfloat16 modes -------------------------------------------------------
# --filter_mxu bf16 and --compute_dtype bfloat16: the CFConv kernels' bf16
# instances (#1-#4, counted as <kernel>_bf16), each against its plain bf16
# version at the JAX package's own bound for the mode
# (tests/test_cfconv_pallas.py's test_bf16_mxu_mode): outputs elementwise
# within rtol 2e-3 and atol 2e-3 x max|plain|; each gradient's mean
# |kernel - plain| within 5% of the f32 gradient's mean magnitude (the f32
# instance's output), and, tighter, its relative norm within 1e-2 (the
# symmetric backward rounds a cell's qe with its mirror's added, the plain
# version each cell's own: ~3e-3 apart). A bf16 step against the same step
# through the plain bf16 versions: loss within 1e-2 relative, gradients
# within 5e-2 relative norm; against the f32 step: the JAX package's drift
# bounds (tests/test_schnet.py: loss as an output, rtol 0.1 / atol 0.05 in
# compute_dtype, 0.02 / 0.01 in filter_mxu; gradients' mean |bf16 - f32|
# within 5% of mean |f32|).
BF16_G = (51, 300)
BF16_BUDGET_S = 150.0
BF16_RTOL = BF16_ATOL = 2e-3
BF16_GRAD_MEAN = 0.05
BF16_GRAD_NORM = 1e-2
BF16_STEP_LOSS = 1e-2
BF16_STEP_NORM = 5e-2
BF16_DRIFT = {"compute_dtype": (0.1, 0.05), "filter_mxu": (0.02, 0.01)}
BF16_FLAGS = {"filter_mxu": ["--filter_mxu", "bf16"],
              "compute_dtype": ["--compute_dtype", "bfloat16"]}
BF16_KERNELS = ("cfconv_fwd", "cfconv_bwd", "cfconv_fwd_sym", "cfconv_bwd_sym")


def bf16_cfg(cfg, mode):
    import dataclasses

    return dataclasses.replace(
        cfg, **{mode: "bf16" if mode == "filter_mxu" else "bfloat16"})


def check_bf16_out(errs, name, got, want, what):
    """A bf16 instance's output: rtol BF16_RTOL, atol BF16_ATOL x max|want|."""
    err = errs._note(name, got, want, what)
    atol = BF16_ATOL * want.abs().max().item()
    if not (got - want).abs().le(atol + BF16_RTOL * want.abs()).all():
        fail(f"{name} {what}: max_abs_err {err:.3e} beyond rtol {BF16_RTOL} "
             f"atol {atol:.3e}")
    print(f"parity {name} {what}: max_abs_err {err:.3e} (atol {atol:.2e})")


def check_bf16_grad(errs, name, got, want, want_f32, what):
    """A bf16 instance's gradient: mean |got - want| within BF16_GRAD_MEAN
    of mean |want_f32|, relative norm within BF16_GRAD_NORM."""
    err = errs._note(name, got, want, what)
    mean = (got - want).abs().mean().item()
    scale = want_f32.abs().mean().item() + 1e-30
    rel = rel_norm(got, want)
    if mean > BF16_GRAD_MEAN * scale or rel > BF16_GRAD_NORM:
        fail(f"{name} {what}: mean_abs_err {mean:.3e} (f32 mean {scale:.3e}),"
             f" rel_norm {rel:.3e}, beyond {BF16_GRAD_MEAN} / "
             f"{BF16_GRAD_NORM}")
    print(f"parity {name} {what}: mean_abs_err {mean / scale:.3e} of the f32 "
          f"mean, rel_norm {rel:.3e}, max_abs_err {err:.3e}")


def bf16_main_path(dev, store, buckets):
    """The bf16 paths at full width, counters reset before and read after:
    a DDM-SchNet epoch of ``pretrain_geossl --compute_dtype bfloat16``
    (buckets 32/64/128, the symmetric pair) and one of ``--filter_mxu bf16
    --max_num_neighbors 32`` (the plain-mode pair), a DDM-PaiNN epoch and
    one ``finetune_lba`` epoch per backbone (B=64, N=512) under
    ``--compute_dtype bfloat16``, and a seeded ``Predictor`` per mode
    serving the store over buckets 32..512. Every bf16 instance must
    launch; no f32 CFConv instance and, in the Predictors, no stack may.
    Returns (counts, the Predictors)."""
    import math

    import numpy as np
    import torch

    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone, make_head

    preds = {}
    for mode in BF16_FLAGS:
        cfg = bf16_cfg(ModelConfig(), mode)
        gen = torch.Generator().manual_seed(SEED)
        state = {"model": make_backbone(cfg, gen).state_dict(),
                 "graph_pred_linear": make_head("schnet", cfg.emb_dim,
                                                gen).state_dict(),
                 "y_mean": 1.5, "y_std": 2.0}
        preds[mode] = Predictor(cfg, state, batch_size=128,
                                bucket_sizes=buckets)
    reset_launch_counts()
    t0 = time.time()
    runs = []
    for tag, argv in (
            ("DDM-SchNet compute_dtype", ["--synthetic_size", "256",
                                          *BF16_FLAGS["compute_dtype"]]),
            ("DDM-SchNet filter_mxu max_neighbors=32", [
                "--synthetic_size", "256", *BF16_FLAGS["filter_mxu"],
                "--max_num_neighbors", "32"]),
            ("DDM-PaiNN compute_dtype", ["--synthetic_size", "128",
                                         "--model_3d", "painn",
                                         *BF16_FLAGS["compute_dtype"]])):
        run_dir = os.path.join(ROOT, "runs", "chip_smoke_bf16")
        shutil.rmtree(run_dir, ignore_errors=True)
        _, losses = PG.main(["--synthetic", "--synthetic_max_atoms", "100",
                             "--epochs", "1", "--output_model_dir", run_dir,
                             *argv])
        runs.append(f"{tag} {len(losses)} steps")
        if not losses or not all(math.isfinite(v) for v in losses):
            fail(f"bf16 {tag}: losses {losses}")
    for model_3d in ("schnet", "painn"):
        run_dir = os.path.join(ROOT, "runs", "chip_smoke_bf16_lba")
        shutil.rmtree(run_dir, ignore_errors=True)
        _, best, _, losses = FL.main([
            "--synthetic", "--synthetic_size", "80", "--epochs", "1",
            "--model_3d", model_3d, "--output_model_dir", run_dir,
            *BF16_FLAGS["compute_dtype"]])
        runs.append(f"LBA-{model_3d} compute_dtype {len(losses)} step(s)")
        if not losses or not all(math.isfinite(v) for v in losses) or \
                not math.isfinite(best):
            fail(f"bf16 finetune_lba {model_3d}: losses {losses}, best {best}")
    before = launch_counts()
    got = {mode: p.predict(store) for mode, p in preds.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"bf16 main path: {', '.join(runs)}, {len(store)} molecules served "
          f"per mode in {time.time() - t0:.2f} s; launches {counts}")
    for name in BF16_KERNELS:
        if counts[name + "_bf16"] == 0:
            fail(f"kernel {name}'s bf16 instance was not launched on the "
                 "bf16 paths")
        if counts[name]:
            fail(f"kernel {name}'s f32 instance launched on a bf16 path")
    for name in ("painn_fwd", "painn_bwd", "ncsn_score_fwd", "ncsn_score_bwd"):
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the bf16 paths")
    for name in ("schnet_stack", "painn_stack"):
        if counts[name] != before[name]:
            fail(f"a bf16 Predictor launched {name}")
    for mode, p in preds.items():
        if any(p.stack_route(n) for n in buckets) or \
                not np.isfinite(got[mode]).all():
            fail(f"bf16 Predictor {mode}: a stack route or non-finite output")
    print("bf16 Predictors: the per-block route at every bucket, no stack "
          "launch")
    return counts, preds, got


def bf16_serving(preds, got, store, buckets, first, layer0_inputs):
    """Each bf16 Predictor against its plain path on 8 molecules per bucket
    (filter_mxu: the kernels' output bound, rtol/atol 2e-3 x max;
    compute_dtype: bf16 rounding flips travel through the blocks, so the
    relative norm, within 1e-2), then one seal of the compute_dtype
    Predictor over buckets 32 and 64, replayed against the live one (the
    same relative norm)."""
    import tempfile

    import numpy as np
    import torch

    from geossl_tpu_torch.export import SealedPredictor, seal

    with torch.inference_mode():
        for mode, p in preds.items():
            worst = 0.0
            for b in buckets:
                idx = first(b, 8)
                batch, *_ = layer0_inputs(p.model, idx, b)
                graph, _ = p.model(batch.atom_type, batch.positions,
                                   batch.node_mask, plain=True)
                want = (p.head(graph) * p.y_std + p.y_mean).float().cpu()
                have = torch.from_numpy(got[mode][idx])
                if mode == "filter_mxu":
                    atol = BF16_ATOL * want.abs().max().item()
                    ok = (have - want).abs().le(atol + BF16_RTOL
                                                * want.abs()).all()
                    err = (have - want).abs().max().item()
                else:
                    err = rel_norm(have, want)
                    ok = err <= BF16_GRAD_NORM
                worst = max(worst, err)
                if not ok:
                    fail(f"bf16 Predictor {mode} bucket {b}: kernel path vs "
                         f"plain path, error {err:.3e}")
            print(f"bf16 serve parity {mode}: buckets {list(buckets)} agree "
                  f"with the plain path (worst "
                  f"{'max_abs_err' if mode == 'filter_mxu' else 'rel_norm'} "
                  f"{worst:.3e})")
    p = preds["compute_dtype"]
    sub = store.select(np.concatenate([first(b, 16) for b in (32, 64)]))
    live = type(p)(p.cfg, {"model": p.model.state_dict(),
                           "graph_pred_linear": p.head.state_dict(),
                           "y_mean": p.y_mean, "y_std": p.y_std},
                   batch_size=16, bucket_sizes=(32, 64))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "runs")) as d:
        t0 = time.time()
        path = os.path.join(d, "bf16.sealed")
        sizes = seal(live, path, modes=("predict",))
        sealed = SealedPredictor.load(path).predict(sub)
    # the same kernels, but the symmetric forward sums with atomics: a
    # message an ulp apart can round h to the other bf16 neighbour, which
    # the later blocks carry (two live passes differ so too), so the
    # compute_dtype serving bound, relative norm 1e-2
    want, again = live.predict(sub), live.predict(sub)
    err, spread = (rel_norm(torch.from_numpy(a), torch.from_numpy(want))
                   for a in (sealed, again))
    if err > BF16_GRAD_NORM:
        fail(f"bf16 sealed predict vs live: rel_norm {err:.3e}")
    print(f"bf16 sealed: {sorted(sizes)} in {time.time() - t0:.1f} s, "
          f"{len(sub)} molecules against the live Predictor, rel_norm "
          f"{err:.3e} (two live passes: {spread:.3e})")


def bf16_kernels(dev, errs, g, cases, cfg, cutoff, timed, tag=None,
                 forward=True, backward=True):
    """#1-#4's bf16 instances at ``g`` Gaussians on their paths' shapes,
    each against its plain bf16 version (chunked), gating off and on: #1
    and #2 on the DDM ``max_num_neighbors 32`` batch (B=128, N=128), #3 on
    the DDM batch, #4 at the LBA shape (B=64, N=512; ddist/denv by the
    placement contract); ``forward`` / ``backward``: #1/#3, #2/#4. Above
    F = 128 the backwards run their hidden-block instance, held to its
    plain version (``cfconv_bwd_bf16_blocks_reference``). Checks are
    recorded as ``<kernel><tag>``, by default ``_bf16`` (G=51) and
    ``_bf16_g<g>``. With ``timed``: the rows (name, source, replaces, ms,
    plain_ms, flops, bytes) of the kernel table, counted as the f32 rows'
    and bounded at the bf16 peak. The filter width is ``cfg``'s (``cases``
    at that width)."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.train.common import make_backbone
    from geossl_tpu_torch.utils import flops

    F_ = cfg.schnet.num_filters
    m = make_backbone(schnet_at(cfg, g),
                      torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        fw = [t.contiguous() for t in m.interactions[0].filter_weights()]
    args = (0.0, cutoff, g)
    flop_pair = 2 * g * F_ + 2 * F_ * F_ + 2 * F_
    wsize = g * F_ + 2 * F_ + F_ * F_
    if tag is None:
        tag = "_bf16" + ("" if g == 51 else f"_g{g}")
    rows = []

    def row(kernel, ms, plain_ms, work, nbytes, shape):
        src, replaces = GAUSS_KERNELS[kernel]
        if F_ > K.KERNEL_F and kernel in FINAL_KERNELS:
            src, replaces = FINAL_KERNELS[kernel]
        rows.append((kernel + tag, src, replaces, ms, plain_ms, work, nbytes,
                     {"shape": shape, "mxu": "bf16"}))

    def fwd_case(kernel, fwd, d, e, x, what, chunk):
        with torch.no_grad():
            want = chunked(K.cfconv_fused_reference, (d, e, x),
                           (*fw, *args, "bf16"), chunk)
            for sp in (False, True):
                check_bf16_out(errs, kernel + tag,
                               fwd(d, e, x, *fw, *args, sp, "bf16"), want,
                               f"{what} sparse={sp}")
            if timed:
                nnz, filt, cells, tiles = pair_work(d, e)
                row(kernel, cuda_time_ms(lambda: fwd(d, e, x, *fw, *args,
                                                     True, "bf16")),
                    cuda_time_ms(lambda: chunked(K.cfconv_fused_reference,
                                                 (d, e, x),
                                                 (*fw, *args, "bf16"), chunk),
                                 reps=3, warmup=1),
                    (filt * (flop_pair - 2 * F_), nnz * 2 * F_),
                    4 * (cells + tiles + 2 * x.numel()
                         + sum(t.numel() for t in fw)), what)

    def bwd_case(kernel, bwd, ref, d, e, x, gr, what, sym):
        chunk = 4
        if F_ > K.KERNEL_F:  # the hidden-block instance's plain version,
            # in chunks of F = 128's cells at N = 512
            ref = lambda *a: K.cfconv_bwd_bf16_blocks_reference(*a[:-1])  # noqa: E731
            chunk = max(1, 4 * 512 * 512 * K.KERNEL_F // (d[0].numel() * F_))
        want = chunked_sum(ref, (d, e, x, gr), (*fw, *args, "bf16"), chunk, 3)
        if sym:
            want = (*(K.place_sym_cotangent(w) for w in want[:2]), *want[2:])
        occ = tile_occupied(e)
        for sp in (False, True):
            got = bwd(d, e, x, gr, *fw, *args, sp, "bf16")
            f32 = bwd(d, e, x, gr, *fw, *args, sp)  # the scale
            for k, (out, a, w, w32) in enumerate(zip(BWD_NAMES, got, want,
                                                     f32)):
                if sp and k < 2:
                    if (a[~occ] != 0).any():
                        fail(f"{kernel + tag} {what} {out}: nonzero on an "
                             "empty tile")
                    w = torch.where(occ, w, torch.zeros_like(w))
                check_bf16_grad(errs, kernel + tag, a, w, w32,
                                f"{what} sparse={sp} {out}")
        if timed:
            nnz, filt, cells, tiles = pair_work(d, e)
            # the plain version once: it repeats the kernel's arithmetic
            # and is no yardstick (above F = 128 it takes seconds at N=512)
            reps = (3, 1) if F_ <= K.KERNEL_F else (1, 0)
            row(kernel, cuda_time_ms(lambda: bwd(d, e, x, gr, *fw, *args,
                                                 True, "bf16")),
                cuda_time_ms(lambda: chunked_sum(ref, (d, e, x, gr),
                                                 (*fw, *args, "bf16"), chunk,
                                                 3),
                             reps=reps[0], warmup=reps[1]),
                flops.cfconv_bwd_kernel(g, F_, filt, nnz, sym),
                4 * (cells + tiles + 2 * d.numel() + 3 * x.numel()
                     + 2 * wsize), what)

    d, e, x, gr = cases["ddm_mn"]
    if forward:
        fwd_case("cfconv_fwd", K.cfconv_fused, d, e, x,
                 "DDM max_neighbors=32 B=128 N=128", 4)
    if backward:
        bwd_case("cfconv_bwd", K.cfconv_bwd, K.cfconv_bwd_reference, d, e, x,
                 gr, "DDM max_neighbors=32 B=128 N=128", False)
    d, e, x, gr = cases["ddm"]
    if forward:
        fwd_case("cfconv_fwd_sym", K.cfconv_fused_sym, d, e, x,
                 "DDM B=128 N=128", 16)
    d, e, x, gr = cases["lba"]
    if backward:
        bwd_case("cfconv_bwd_sym", K.cfconv_bwd_sym,
                 K.cfconv_bwd_sym_reference, d, e, x, gr, "LBA B=64 N=512",
                 True)
    return rows


def bf16_steps(dev, cfg, train_batch, buckets):
    """(b) Per bf16 mode, one full-width DDM-SchNet step per bucket (a
    freshly seeded module, injected noise) against the same step through
    the plain bf16 versions and against the f32 step with the same weights
    (tolerances in the header of this phase)."""
    import torch

    from geossl_tpu_torch.train import pretrain_geossl as PG

    for mode in BF16_FLAGS:
        targs = PG.build_parser().parse_args(BF16_FLAGS[mode])
        ddm = PG.make_ddm(targs, bf16_cfg(cfg, mode),
                          torch.Generator().manual_seed(SEED)).to(dev)
        ddm32 = PG.make_ddm(targs, cfg,
                            torch.Generator().manual_seed(SEED)).to(dev)
        ddm32.load_state_dict(ddm.state_dict())
        rtol, atol = BF16_DRIFT[mode]
        for b in buckets:
            batch = train_batch(b)
            pos2, sel, draws = step_draws(ddm, batch, targs, b)
            loss_k, grads_k = ddm_grads(ddm, batch, pos2, sel, draws)
            ddm.plain = True
            loss_p, grads_p = ddm_grads(ddm, batch, pos2, sel, draws,
                                        chunk=16)
            ddm.plain = False
            loss_f, grads_f = ddm_grads(ddm32, batch, pos2, sel, draws)
            cat = lambda gs: torch.cat([t.flatten() for t in gs.values()])
            rel_k = rel_norm(cat(grads_k), cat(grads_p))
            if abs(loss_k - loss_p) > BF16_STEP_LOSS * abs(loss_p) or \
                    rel_k > BF16_STEP_NORM:
                fail(f"bf16 step {mode} bucket {b}: loss {loss_k} vs plain "
                     f"{loss_p}, gradients rel_norm {rel_k:.3e}")
            drift = (cat(grads_k) - cat(grads_f)).abs().mean().item() / \
                cat(grads_f).abs().mean().item()
            if abs(loss_k - loss_f) > atol + rtol * abs(loss_f) or \
                    drift > BF16_GRAD_MEAN:
                fail(f"bf16 step {mode} bucket {b}: loss {loss_k} vs f32 "
                     f"{loss_f}, gradients' mean drift {drift:.3e}")
            print("bf16_step_parity: " + json.dumps({
                "mode": mode, "bucket": b, "loss": loss_k,
                "loss_plain": loss_p, "loss_f32": loss_f,
                "grad_rel_norm_vs_plain": rel_k,
                "grad_mean_drift_vs_f32": drift}))


def bf16_step_times(dev, cfg, batch, card, rounds=2):
    """(e) The DDM-SchNet step's device ms at bucket 128 in f32, in
    ``--filter_mxu bf16`` and in ``--compute_dtype bfloat16`` (seeded
    modules, one optimizer each), one traced step of each mode in turns
    (f32, filter_mxu, compute_dtype, then back), after a warm-up."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    steps = {}
    for mode in ("f32", *BF16_FLAGS):
        flags = BF16_FLAGS.get(mode, [])
        targs = PG.build_parser().parse_args(flags)
        c = cfg if mode == "f32" else bf16_cfg(cfg, mode)
        ddm = PG.make_ddm(targs, c, torch.Generator().manual_seed(SEED)).to(dev)
        opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(),
                                                     100)
        gen = torch.Generator(dev).manual_seed(SEED)
        steps[mode] = (lambda ddm=ddm, opt=opt, sched=sched, targs=targs,
                       gen=gen: PG.train_step(ddm, opt, sched, [batch],
                                              targs, gen))
        steps[mode]()
    torch.cuda.synchronize()
    busy = {mode: [] for mode in steps}
    ours = {mode: [] for mode in steps}
    order = list(steps)
    for r in range(rounds):
        for mode in (order if r % 2 == 0 else order[::-1]):
            _, b_, o_ = device_profile(steps[mode])
            busy[mode].append(b_ * 1e3)
            ours[mode].append(o_ * 1e3)
    line = {"card": card, "bucket": 128, "rounds": rounds, "order":
            "f32, filter_mxu, compute_dtype, then reversed",
            "device_ms": {m: sum(v) / len(v) for m, v in busy.items()},
            "port_kernels_ms": {m: sum(v) / len(v) for m, v in ours.items()},
            "device_ms_each": busy}
    print("bf16_step: " + json.dumps(line))


def bf16_path(dev, card, errs, cfg, cutoff, cases, store, buckets, first,
              layer0_inputs, train_batch, train_buckets):
    """Phase 6: the bf16 modes. The main paths (their launches are the
    rows' counts), each bf16 instance against its plain bf16 version at G =
    51 and 300 (timed at 51), a DDM-SchNet step per bucket and mode against
    the plain and the f32 steps, the bf16 Predictors against their plain
    paths and one sealed, and the step's device ms per mode. Returns the
    kernel table's bf16 rows, with their launches."""
    t0 = time.time()
    launches, preds, got = bf16_main_path(dev, store, buckets)
    bf16_serving(preds, got, store, buckets, first, layer0_inputs)
    del preds, got
    rows = []
    for g in BF16_G:
        for name, src, replaces, ms, plain_ms, flops, nbytes, extra in \
                bf16_kernels(dev, errs, g, cases, cfg, cutoff, g == 51):
            base = name.split("_bf16")[0]
            rows.append((name, src, replaces, ms, plain_ms, flops, nbytes,
                         launches[base + "_bf16"], extra))
    bf16_steps(dev, cfg, train_batch, train_buckets)
    bf16_step_times(dev, cfg, train_batch(128), card)
    seconds = time.time() - t0
    print("bf16: " + json.dumps({
        "card": card, "seconds": seconds,
        "launches": {k: v for k, v in launches.items() if v},
        "rows": {name: {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
                        "launches": count, **extra}
                 for name, _, _, ms, plain_ms, flops, nbytes, count, extra
                 in rows}}))
    if seconds > BF16_BUDGET_S:
        fail(f"bf16: {seconds:.1f} s, above its {BF16_BUDGET_S:.0f} s")
    return rows

# -- 7. any width -----------------------------------------------------------------
# emb_dim = num_filters of the phase's paths: 256 runs #1-#4 in column blocks
# and #6/#7 in the kE = 256 instance, 96 pads into the 128 instances
WIDTHS = (256, 96)
WIDTH_BUDGET_S = 120.0
# kernel -> (source, the TPU kernel it replaces)
WIDTH_KERNELS = {
    **GAUSS_KERNELS,
    "ncsn_score_fwd": ("geossl_tpu_torch/ops/csrc/ncsn_score.cu",
                       "geossl_tpu/ops/ncsn_pallas.py:67"),
    "ncsn_score_bwd": ("geossl_tpu_torch/ops/csrc/ncsn_score.cu",
                       "geossl_tpu/ops/ncsn_pallas.py:135"),
}


def width_cfg(cfg, w, max_neighbors=None):
    """``cfg`` at emb_dim = hidden_channels = num_filters = ``w``."""
    import dataclasses

    return dataclasses.replace(
        cfg, emb_dim=w, max_neighbors=max_neighbors,
        schnet=dataclasses.replace(cfg.schnet, hidden_channels=w,
                                   num_filters=w))


def head_instance(w):
    """The launch counters' suffix of the NCSN instance a head of width w
    runs in."""
    from geossl_tpu_torch.ops import ncsn as NS

    width = NS.instance_width(w)
    return "_wide" if NS.streamed(width) else "_e256" if width == 256 else ""


def widths_main_path(dev, w, cfg, store, buckets, first, layer0_inputs):
    """SchNet's paths at emb_dim = num_filters = ``w`` (6 blocks, G=51,
    cutoff 10), counters reset before and read after: a DDM epoch of
    ``pretrain_geossl --emb_dim w --num_filters w`` on 256 molecules (2 x 6
    x k^2 launches of #3 and #4 per step and none of #1/#2; the heads in
    their width's instance only), one with ``--max_num_neighbors 32``, and
    a seeded Predictor and its ``max_neighbors=32`` twin serving the store
    (per block at every bucket above F=128, through the padded stack up to
    N=128 below), held to the plain path on 8 molecules per bucket (rtol
    1e-4, atol 1e-5 x max). Returns the counts."""
    import math

    import numpy as np
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone, make_head

    cw = width_cfg(cfg, w)
    gen = torch.Generator().manual_seed(SEED)
    state = {"model": make_backbone(cw, gen).state_dict(),
             "graph_pred_linear": make_head("schnet", w, gen).state_dict(),
             "y_mean": 1.5, "y_std": 2.0}
    preds = {what: Predictor(width_cfg(cfg, w, mn), state, batch_size=128,
                             bucket_sizes=buckets)
             for what, mn in (("default", None), ("max_neighbors=32", 32))}
    k2, layers = K.launches_per_call(w), cw.schnet.num_interactions
    head, other = head_instance(w), head_instance(128 if w > 128 else 256)
    reset_launch_counts()
    t0 = time.time()
    steps = []
    for extra in ([], ["--max_num_neighbors", "32"]):
        run_dir = os.path.join(ROOT, "runs", f"chip_smoke_w{w}")
        shutil.rmtree(run_dir, ignore_errors=True)
        _, losses = PG.main(["--synthetic", "--synthetic_size", "256",
                             "--synthetic_max_atoms", "100", "--epochs", "1",
                             "--output_model_dir", run_dir, "--emb_dim",
                             str(w), "--num_filters", str(w), *extra])
        steps.append(len(losses))
        if not losses or not all(math.isfinite(v) for v in losses):
            fail(f"pretrain_geossl emb=F={w} {extra}: losses {losses}")
        if not extra:
            c = launch_counts()
            want = 2 * layers * k2 * len(losses)  # two views, k^2 a call
            got = (c["cfconv_fwd_sym"], c["cfconv_bwd_sym"], c["cfconv_fwd"],
                   c["cfconv_bwd"])
            heads = (c["ncsn_score_fwd" + head], c["ncsn_score_bwd" + head],
                     c["ncsn_score_fwd" + other], c["ncsn_score_bwd" + other])
            print(f"widths launches emb=F={w}: {len(losses)} steps, #3/#4/"
                  f"#1/#2 {got} (want {want} of #3 and #4, k^2 = {k2} a "
                  f"call), heads {heads}")
            if got != (want, want, 0, 0) or \
                    heads != (2 * len(losses), 2 * len(losses), 0, 0):
                fail(f"widths emb=F={w}: launches {got}, heads {heads}")
    before = launch_counts()
    got = {what: p.predict(store) for what, p in preds.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    stacked = counts["schnet_stack"] - before["schnet_stack"]
    print(f"widths main path emb=F={w}: DDM {steps[0]} steps, max_neighbors "
          f"{steps[1]} steps, {len(store)} molecules served twice in "
          f"{time.time() - t0:.2f} s ({stacked} stack launches); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for name in ("cfconv_fwd", "cfconv_bwd", "cfconv_fwd_sym",
                 "cfconv_bwd_sym", "ncsn_score_fwd" + head,
                 "ncsn_score_bwd" + head):
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the emb=F={w} paths")
    if (stacked > 0) != (w <= K.KERNEL_F) or any(
            p.stack_route(n) != (w <= K.KERNEL_F and n <= 128)
            for p in preds.values() for n in buckets):
        fail(f"Predictor emb=F={w}: stack route {stacked} launches")
    with torch.inference_mode():
        for what, p in preds.items():
            if not np.isfinite(got[what]).all():
                fail(f"Predictor emb=F={w} {what}: non-finite output")
            for b in buckets:
                idx = first(b, 8)
                batch, *_ = layer0_inputs(p.model, idx, b)
                graph, _ = p.model(batch.atom_type, batch.positions,
                                   batch.node_mask, plain=True)
                want = (p.head(graph) * p.y_std + p.y_mean).cpu().numpy()
                atol = ATOL * max(1.0, float(np.abs(want).max()))
                if not np.allclose(got[what][idx], want, rtol=RTOL, atol=atol):
                    fail(f"Predictor emb=F={w} {what} bucket {b}: kernel path"
                         f" vs plain path, max_abs_err "
                         f"{np.abs(got[what][idx] - want).max():.3e}")
        print(f"widths serve parity emb=F={w}: buckets {list(buckets)} agree "
              "with the plain path (default and max_neighbors=32)")
    return counts


def widen_cases(dev, cases, w):
    """Phase 5's kernel inputs with x, h0 and the cotangents projected to
    width ``w`` by a seeded matrix (scaled to keep their magnitude); the
    pair grids as they are."""
    import torch

    proj = torch.randn(128, w, generator=torch.Generator().manual_seed(
        SEED + w)).to(dev) / 128 ** 0.5
    out = {}
    for key, case in cases.items():
        if isinstance(case, int):
            out[key] = case
            continue
        d, e, *feats = case
        out[key] = (d, e, *((t @ proj).contiguous() for t in feats))
    return out


def widths_ncsn(dev, errs, w, cfg, batch, tag, timed=True):
    """#6/#7 at head width ``w`` on the DDM batch of bucket 128 (a seeded DDM
    at the width), against their plain versions (recorded under
    ``ncsn_score_*<tag>``), two launches bitwise equal; with ``timed`` the
    kernel table's rows, bounds counted at the user's width
    (``utils/flops.ncsn_head_kernel``)."""
    import ctypes

    import torch

    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import ncsn as NS
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.utils import flops

    targs = PG.build_parser().parse_args(["--emb_dim", str(w)])
    ddm = PG.make_ddm(targs, width_cfg(cfg, w),
                      torch.Generator().manual_seed(SEED)).to(dev)
    grid, weights, anneal = ncsn_inputs(ddm, batch, targs, SEED)
    what = f"DDM B=128 N=128 E={w}"
    g_rows = check_ncsn(errs, grid, weights, anneal, what, chunk=16, tag=tag)
    again = [NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal)
             for _ in range(2)]
    rows2 = [NS.ncsn_score_fwd(*grid, *weights, anneal=anneal)
             for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*again)) or \
            not torch.equal(*rows2):
        fail(f"ncsn_score{tag}: outputs differ between two launches")
    if not timed:
        return []
    width = NS.instance_width(w)
    if NS.streamed(width):  # one layout for both directions, at any E
        smem = dict.fromkeys(("fwd", "bwd"), _build.kernel_fn(
            "ncsn_score_wide", "ncsn_wide_smem_bytes", [], ctypes.c_size_t)())
    else:
        lib = "ncsn_score" + ("_e256" if width == 256 else "")
        smem = {d: _build.kernel_fn(lib, "ncsn_dir_smem_bytes", [ctypes.c_int],
                                    ctypes.c_size_t)(int(d == "fwd"))
                for d in ("fwd", "bwd")}
    sel_pairs = int((grid[2] != 0).sum())
    bsz, n = grid[0].shape[:2]
    head_w = sum(t.numel() for t in weights)
    rows = []
    kernels = FINAL_KERNELS if NS.streamed(width) else WIDTH_KERNELS
    for name, fn, plain, work, nbytes in (
            ("ncsn_score_fwd",
             lambda: NS.ncsn_score_fwd(*grid, *weights, anneal=anneal),
             lambda: chunked(NS.ncsn_score_loss_reference, grid,
                             (*weights, anneal), 16),
             flops.ncsn_head_kernel(w, sel_pairs),
             4 * (3 * grid[0].numel() + grid[4].numel() + bsz + head_w
                  + bsz * n)),
            ("ncsn_score_bwd",
             lambda: NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal),
             lambda: chunked_sum(
                 lambda *a: NS.ncsn_score_bwd_reference(*a, anneal=anneal),
                 (*grid, g_rows), weights, 16, 1),
             flops.ncsn_head_kernel(w, sel_pairs, backward=True),
             4 * (3 * grid[0].numel() + 2 * grid[4].numel() + bsz
                  + bsz * n + 2 * head_w))):
        rows.append((name + tag, kernels[name][0], kernels[name][1],
                     cuda_time_ms(fn), cuda_time_ms(plain, reps=3, warmup=1),
                     work, nbytes,
                     {"shape": what, "instance_width": width,
                      "smem_bytes": smem["fwd" if name.endswith("fwd")
                                         else "bwd"]}))
    return rows


def widths_step_times(dev, cfg, batch):
    """The device ms of one DDM-SchNet step at bucket 128 (a seeded module,
    traced after a warm-up) at each width of the phase and at 128."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    out = {}
    for w in (*WIDTHS, 128):
        targs = PG.build_parser().parse_args(["--emb_dim", str(w),
                                              "--num_filters", str(w)])
        ddm = PG.make_ddm(targs, width_cfg(cfg, w),
                          torch.Generator().manual_seed(SEED)).to(dev)
        opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(),
                                                     100)
        gen = torch.Generator(dev).manual_seed(SEED)

        def step():
            return PG.train_step(ddm, opt, sched, [batch], targs, gen)

        step()
        torch.cuda.synchronize()
        _, busy, ours = device_profile(step)
        out[f"emb=F={w}"] = {"device_ms": busy * 1e3,
                             "port_kernels_ms": ours * 1e3}
    return out


def widths_refusals(dev):
    """On the card, the refusals above the kernels' limits, each naming
    its flag or width: ``pretrain_geossl --model_3d painn --painn_n_rbf 1``
    (the PaiNN kernels take R >= 2) and ``models/painn.stack_train_apply``
    at F = 256 (the PaiNN stack takes up to 128). (The NCSN head at any
    --emb_dim and the bf16 backwards at any --num_filters: phase 9.)"""
    import torch

    from geossl_tpu_torch.models.painn import stack_train_apply
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone

    said = {}
    wide = make_backbone(painn_cfg(256, 20),
                         torch.Generator().manual_seed(SEED)).to(dev)
    z = torch.ones((2, 16), dtype=torch.long, device=dev)
    pos = torch.randn((2, 16, 3), generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    mask = torch.ones((2, 16), dtype=torch.bool, device=dev)
    for flag, fn in (
            ("--painn_n_rbf 1", lambda: PG.main([
                "--synthetic", "--synthetic_size", "16", "--model_3d",
                "painn", "--painn_n_rbf", "1", "--output_model_dir",
                os.path.join(ROOT, "runs", "refused")])),
            ("F=256", lambda: stack_train_apply(wide, z, pos, mask))):
        try:
            fn()
        except ValueError as e:
            if flag not in str(e):
                fail(f"widths refusal: {e} does not name {flag}")
            said[flag] = str(e)
            continue
        fail(f"widths: {flag} was not refused at startup")
    return said


def widths_path(dev, card, errs, cfg, cutoff, cases, store, buckets, first,
                layer0_inputs, train_batch):
    """Phase 7: SchNet and the DDM head at emb = F = 256 and 96. The main
    paths (their launches are the rows' counts) and one step per width
    against the plain step, then #1-#7 against their plain versions at
    each width (timed in f32 at G=51), the step's device ms per width and
    the startup refusals. Returns the
    kernel table's width rows, with their launches."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.train import pretrain_geossl as PG

    t0 = time.time()
    batch = train_batch(128)
    rows = []
    for w in WIDTHS:
        launches = widths_main_path(dev, w, cfg, store, buckets, first,
                                    layer0_inputs)
        targs = PG.build_parser().parse_args(["--emb_dim", str(w),
                                              "--num_filters", str(w)])
        ddm = PG.make_ddm(targs, width_cfg(cfg, w),
                          torch.Generator().manual_seed(SEED)).to(dev)
        step_parity(ddm, batch, targs, 128, f"SchNet emb=F={w}")
        del ddm
        wcases, cw = widen_cases(dev, cases, w), width_cfg(cfg, w)
        gaussians_kernels(dev, errs, 300, wcases, cw, cutoff, False,
                          tag=f"_f{w}_g300")
        # (the bf16 backwards above F = 128: phase 9)
        bf16_kernels(dev, errs, 51, wcases, cw, cutoff, False,
                     tag=f"_f{w}_bf16", backward=w <= K.KERNEL_F)
        head = head_instance(w)
        ncsn_tag = head or f"_e{w}"
        # (row, its launch counter, launches a call)
        timed = [(r, r[0][:-len(f"_f{w}")], K.launches_per_call(w))
                 for r in gaussians_kernels(dev, errs, 51, wcases, cw, cutoff,
                                            True, tag=f"_f{w}")]
        timed += [(r, r[0][:-len(ncsn_tag)] + head, 1)
                  for r in widths_ncsn(dev, errs, w, cfg, batch, ncsn_tag)]
        for (name, src, replaces, ms, plain_ms, flops, nbytes, extra), \
                counter, per_call in timed:
            rows.append((name, src, replaces, ms, plain_ms, flops, nbytes,
                         launches[counter], {**extra, "width": w,
                                             "launches_per_call": per_call}))
    steps = widths_step_times(dev, cfg, batch)
    refusals = widths_refusals(dev)
    log = _build.build_log("ncsn_score_e256")
    ptxas = {k: ptxas_usage(log, KERNEL_ENTRIES[f"ncsn_score_{k}_e256"][1])
             for k in ("fwd", "bwd")}
    seconds = time.time() - t0
    print("widths: " + json.dumps({
        "card": card, "seconds": seconds,
        "ddm_step_bucket_128": steps,
        "ncsn_e256_ptxas": ptxas,
        "refusals": refusals,
        "rows": {name: {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(flops, nbytes),
                        "launches": count, **extra}
                 for name, _, _, ms, plain_ms, flops, nbytes, count, extra
                 in rows}}))
    if seconds > WIDTH_BUDGET_S:
        fail(f"widths: {seconds:.1f} s, above its {WIDTH_BUDGET_S:.0f} s")
    return rows


# -- Phase 8: PaiNN at any width and any RBF count ------------------------------

PAINN_WIDTH_BUDGET_S = 240.0
# (emb_dim = n_atom_basis, n_rbf): two column blocks, padded, and the
# streamed filter product in two and in three passes
PAINN_SETTINGS = ((256, 20), (96, 20), (128, 32), (128, 64))
# the kernel table's row tag of each timed setting
PAINN_ROW_TAGS = {(256, 20): "_f256", (96, 20): "_f96", (128, 64): "_r64"}
# kernel -> (source, the TPU kernel it replaces)
PAINN_KERNELS = {
    "painn_fwd": ("geossl_tpu_torch/ops/csrc/painn_fwd.cu",
                  "geossl_tpu/ops/painn_pallas.py:86"),
    "painn_bwd": ("geossl_tpu_torch/ops/csrc/painn_bwd.cu",
                  "geossl_tpu/ops/painn_pallas.py:164"),
    "painn_fwd_sym": ("geossl_tpu_torch/ops/csrc/painn_fwd.cu",
                      "geossl_tpu/ops/painn_pallas.py:435"),
    "painn_bwd_sym": ("geossl_tpu_torch/ops/csrc/painn_bwd.cu",
                      "geossl_tpu/ops/painn_pallas.py:540"),
    "painn_stack": ("geossl_tpu_torch/ops/csrc/painn_stack.cu",
                    "geossl_tpu/ops/painn_pallas.py:829"),
}


def painn_cfg(w, r):
    """PaiNN's published configuration (3 blocks, cutoff 5) at emb_dim =
    n_atom_basis = ``w`` and n_rbf = ``r``."""
    import dataclasses

    from geossl_tpu_torch.config import ModelConfig

    cfg = ModelConfig(model_3d="painn")
    return dataclasses.replace(cfg, emb_dim=w, painn=dataclasses.replace(
        cfg.painn, n_atom_basis=w, n_rbf=r))


def painn_flags(w, r):
    return ["--model_3d", "painn", "--emb_dim", str(w), "--painn_n_rbf",
            str(r)]


@contextlib.contextmanager
def message_calls():
    """{"fwd": calls, "bwd": calls} of the message-pass launch functions
    while inside (a call makes k launches of its kernel at F > 128)."""
    from geossl_tpu_torch.ops import painn as P

    calls = {"fwd": 0, "bwd": 0}
    real = {k: getattr(P, f"_launch_painn_{k}") for k in calls}

    def counting(k):
        def fn(*args):
            calls[k] += 1
            return real[k](*args)
        return fn

    for k in calls:
        setattr(P, f"_launch_painn_{k}", counting(k))
    try:
        yield calls
    finally:
        for k in calls:
            setattr(P, f"_launch_painn_{k}", real[k])


def painn_widths_main_path(dev, w, r, store, buckets, first, packed):
    """(a) A seeded PaiNN Predictor at emb_dim = ``w``, n_rbf = ``r`` serving
    the store over buckets 32..512 (F > 128: the per-block route at every
    bucket, no stack launch; F <= 128: the padded stack up to N = 128,
    streamed at R > 31), held to the plain path on 8 molecules per bucket
    (rtol 1e-4, atol 1e-5 x max), and its forces on two LBA complexes at
    N = 512 (the symmetric pair and its backward) held to the plain forces.
    Counters reset before and read after: k calls of the kernel entry a
    message call, each making one launch a filter pass (the library's
    count). Returns (the counts, the message calls)."""
    import numpy as np
    import torch

    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train.common import make_backbone, make_head

    cfg = painn_cfg(w, r)
    gen = torch.Generator().manual_seed(SEED)
    state = {"model": make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": make_head("painn", w, gen).state_dict(),
             "y_mean": 1.5, "y_std": 2.0}
    pred = Predictor(cfg, state, batch_size=128, bucket_sizes=buckets)
    pred_f = Predictor(cfg, state, batch_size=128, bucket_sizes=(512,))
    forces_store = store.select(first(512, 2))
    k, stack = P.feature_blocks(w), w <= P.KERNEL_F
    per_call = k * painn_passes(r)
    what = f"emb={w} R={r}"
    reset_launch_counts()
    t0 = time.time()
    with message_calls() as calls:
        got = pred.predict(store)
        energies, forces = pred_f.predict_forces(forces_store)
        torch.cuda.synchronize()
    counts = launch_counts()
    fwd = counts["painn_fwd"] + counts["painn_fwd_sym"]
    bwd = counts["painn_bwd"] + counts["painn_bwd_sym"]
    print(f"painn_widths main path {what}: {len(store)} molecules served, "
          f"forces of 2 complexes at N=512 in {time.time() - t0:.2f} s; "
          f"message calls {calls} (k = {k}, {per_call} launches a call); "
          f"launches { {n: v for n, v in counts.items() if v} }")
    if (fwd, bwd) != (per_call * calls["fwd"], per_call * calls["bwd"]) \
            or not calls["bwd"]:
        fail(f"painn_widths {what}: {fwd} / {bwd} launches for {calls} "
             f"message calls, not {per_call} a call")
    if (counts["painn_stack"] > 0) != stack or any(
            pred.stack_route(n) != (stack and n <= 128) for n in buckets):
        fail(f"Predictor {what}: stack route, {counts['painn_stack']} stack "
             "launches")
    for name in ("painn_fwd_sym", "painn_bwd_sym",
                 "painn_stack" if stack else "painn_fwd"):
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the PaiNN {what} paths")
    with torch.inference_mode():
        if not np.isfinite(got).all():
            fail(f"Predictor {what}: non-finite output")
        for b in buckets:
            idx = first(b, 8)
            batch = packed(idx, b)
            graph, _ = pred.model(batch.atom_type, batch.positions,
                                  batch.node_mask, plain=True)
            want = (pred.head(graph) * pred.y_std + pred.y_mean).cpu().numpy()
            atol = ATOL * max(1.0, float(np.abs(want).max()))
            if not np.allclose(got[idx], want, rtol=RTOL, atol=atol):
                fail(f"Predictor {what} bucket {b}: kernel path vs plain "
                     f"path, max_abs_err {np.abs(got[idx] - want).max():.3e}")
    e_p, f_p = plain_forces(pred_f, forces_store)
    check_forces(f"painn_widths {what} energies", energies, e_p)
    check_forces(f"painn_widths {what} forces", forces, f_p)
    print(f"painn_widths serve parity {what}: buckets {list(buckets)} agree "
          "with the plain path")
    return counts, calls


def painn_widths_steps(dev, w, r, batch, lba_batch):
    """(b) One DDM-PaiNN step at bucket 128 against the plain step (as 3b,
    2 views x 3 blocks x k calls of #8 and of #9, each one launch a filter
    pass) and, at F > 128, one LBA-PaiNN step at B=64, N=512 (the symmetric
    pair) against the plain step computed in chunks of 2 complexes. Returns
    (the steps' counts, their message calls)."""
    import torch

    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import pretrain_geossl as PG

    k, what = P.feature_blocks(w), f"emb={w} R={r}"
    per_call = k * painn_passes(r)
    targs = PG.build_parser().parse_args(painn_flags(w, r))
    ddm = PG.make_ddm(targs, painn_cfg(w, r),
                      torch.Generator().manual_seed(SEED)).to(dev)
    layers = ddm.model.n_interactions
    reset_launch_counts()
    with message_calls() as calls:
        step_parity(ddm, batch, targs, 128, f"PaiNN {what}")
    counts = launch_counts()
    want = 2 * layers * per_call
    if (counts["painn_fwd"], counts["painn_bwd"]) != (want, want) or \
            calls != {"fwd": 2 * layers, "bwd": 2 * layers}:
        fail(f"DDM-PaiNN {what} step: launches {counts['painn_fwd']} / "
             f"{counts['painn_bwd']} for {calls} calls, want {want}")
    del ddm
    if w <= P.KERNEL_F:
        return counts, calls
    lba_args = FL.build_parser().parse_args(lba_flags("painn")
                                            + painn_flags(w, r)[2:])
    net = FL.make_net(lba_args, common.model_config_from_args(lba_args),
                      torch.Generator().manual_seed(SEED)).to(dev)

    def loss(sb, sl):
        return FL.loss_fn(net, sb)

    reset_launch_counts()
    with message_calls() as lba_calls:
        loss_k, grads_k = grads_in_chunks(net, lba_batch, loss)
    lba_counts = launch_counts()
    net.plain = True
    loss_p, grads_p = grads_in_chunks(net, lba_batch, loss, chunk=2)
    check_step_parity(f"LBA-PaiNN {what} step parity bucket 512", loss_k,
                      grads_k, loss_p, grads_p)
    if (lba_counts["painn_fwd_sym"], lba_counts["painn_bwd_sym"]) != \
            (layers * per_call, layers * per_call):
        fail(f"LBA-PaiNN {what} step: launches {lba_counts}")
    return ({n: counts[n] + lba_counts[n] for n in counts},
            {d: calls[d] + lba_calls[d] for d in calls})


def painn_work(kind, grids, x, f, r, layers=3, stacked=None, atoms=0,
               residuals=False):
    """((tensor-core, CUDA-core) operations, bytes) of PaiNN kernel ``kind``
    on these inputs at width ``f`` and ``r`` RBFs. Forwards: the filter
    2R*3F once per needed pair (``pair_work``: one triangle of symmetric
    grids) on the tensor cores, the message sums (dq 2F, dmu 12F) and gating
    3F per ordered pair on the CUDA cores. Backwards: the filter recomputed
    and dWk/dbk once per needed pair, dphi = dwg Wk^T (per ordered pair in
    the plain mode, once per unordered pair in the symmetric one) and ~40F
    elementwise per ordered pair. The stack (``x`` is q0): per block the
    filter, the dense layers (x-MLP 8F^2, mixing 12F^2, context MLP 10F^2
    per atom of ``atoms``) on the tensor cores, the message sums, gating
    and ~20F elementwise per atom on the CUDA cores. Bytes: the gate read
    whole, dist and the directions on its occupied tiles; x and mu (the
    backwards also gq, gmu) read, the outputs written (the backwards' five
    pair cotangents; the stack's q, mu and with ``residuals`` its four
    residual stacks)."""
    nnz, filt, cells, tiles = pair_work(grids[0], grids[1])
    f3 = 3 * f
    fwd_pair, fwd_elem = 2 * r * f3, 17 * f
    if kind == "painn_fwd":
        return ((filt * fwd_pair, nnz * fwd_elem),
                4 * (cells + 4 * tiles + 2 * x.numel() + (r + 1) * f3
                     + x.numel() // 3 + x.numel()))
    if kind == "painn_fwd_sym":
        return ((filt * fwd_pair, nnz * fwd_elem),
                4 * (cells + 4 * tiles + 2 * x.numel() + (r + 1) * f3
                     + 4 * x.numel() // 3))
    if kind == "painn_bwd":
        return ((filt * (2 * r * f3 + 2 * (r + 1) * f3) + nnz * 2 * r * f3,
                 nnz * 40 * f),
                4 * (cells + 4 * tiles + 5 * grids[0].numel() + 5 * x.numel()
                     + x.numel() // 3 + 2 * (r + 1) * f3))
    if kind == "painn_bwd_sym":
        return ((filt * (2 * r * f3 + 2 * (r + 1) * f3 + 2 * r * f3),
                 nnz * 40 * f),
                4 * (cells + 4 * tiles + 5 * grids[0].numel() + 5 * x.numel()
                     + x.numel() // 3 + 2 * (r + 1) * f3))
    t_ops = layers * (filt * fwd_pair + atoms * 30 * f * f)
    e_ops = layers * (nnz * fwd_elem + atoms * 20 * f)
    return ((t_ops, e_ops),
            4 * (cells + 4 * tiles + 5 * x.numel()
                 + sum(t.numel() for t in stacked)
                 + (8 * layers * x.numel() if residuals else 0)))


def painn_widths_kernels(dev, errs, w, r, ddm_batch, lba_batch, serve_batch,
                         timed):
    """(c) #8-#12 at emb_dim = ``w``, n_rbf = ``r`` (block 0 of a seeded
    model) against their plain versions with the F = 128 rows'
    tolerances: #8/#9 on the DDM batch (B=128, N=128, the clean graph,
    gated), #10/#11 on the LBA batch (B=64, N=512; ``check_painn_sym``), #12
    (F <= 128) at serving's first batch at N=32 and, in residual mode, on
    the DDM batch; every kernel a second launch bitwise equal to the first
    (the symmetric pair's atomically summed rows within the tolerance).
    Recorded as ``<kernel><tag>``; with ``timed`` the kernel table's rows
    (name, source, replaces, ms, plain_ms, flops, bytes, extra; extra
    holds the dynamic shared bytes of the launch)."""
    import ctypes

    import torch

    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.train.common import make_backbone

    tag = PAINN_ROW_TAGS.get((w, r), f"_f{w}_r{r}")
    cfg = painn_cfg(w, r)
    m = make_backbone(cfg, torch.Generator().manual_seed(SEED)).to(dev)
    cut, layers = cfg.painn.cutoff, cfg.painn.n_interactions
    big = w > P.KERNEL_F
    with torch.no_grad():
        wk0, bk0 = (t.contiguous() for t in m.filter_weights()[0])
        d1, pm = geometry.pairwise_distances(ddm_batch.positions,
                                             ddm_batch.node_mask)
        clean = geometry.radius_adjacency(d1, pm, cut)
        stacked = [t.contiguous() for t in m.stacked_weights()]
    grids, q0, x, mu = painn_inputs(m, ddm_batch, pair_mask=clean)
    gen = torch.Generator(dev).manual_seed(SEED)
    gq = torch.randn(q0.shape, generator=gen, device=dev)
    gmu = torch.randn(mu.shape, generator=gen, device=dev)
    what = f"DDM B=128 N=128 emb={w} R={r}"
    rows = []

    def smem(kernel, n):
        """The dynamic shared bytes of ``kernel``'s launch at N = n."""
        lib = kernel.replace("_sym", "")
        if lib == "painn_stack":
            return _build.kernel_fn(lib, "painn_stack_smem_bytes", [],
                                    ctypes.c_size_t)()
        if lib == "painn_fwd":
            return _build.kernel_fn(lib, "painn_fwd_smem_bytes",
                                    [ctypes.c_int], ctypes.c_size_t)(
                int(kernel.endswith("_sym")))
        return _build.kernel_fn(lib, "painn_bwd_smem_bytes",
                                [ctypes.c_int] * 2, ctypes.c_size_t)(
            n, int(kernel.endswith("_sym")))

    def row(kernel, fn, plain, work, **extra):
        if timed:
            extra["smem_bytes"] = smem(kernel, 512 if "sym" in kernel else
                                       (32 if "stack" in kernel else 128))
            src, replaces = PAINN_KERNELS[kernel]
            rows.append((kernel + tag, src, replaces, cuda_time_ms(fn),
                         cuda_time_ms(plain, reps=2, warmup=1), *work,
                         {"width": w, "n_rbf": r, **extra}))

    def plain_fwd(grids_, x_, mu_, chunk):
        return chunked(lambda *a: torch.cat(P.painn_message_reference(
            *a, wk0, bk0, cut), dim=-1), (*grids_, x_, mu_), (), chunk)

    def plain_bwd(grids_, x_, mu_, gq_, gmu_, chunk):
        return chunked_sum(
            lambda d, g, a, b_, c, xx, mm, gq2, gmu2: P.painn_bwd_reference(
                d, g, a, b_, c, xx, mm, wk0, bk0, gq2, gmu2, cut),
            (*grids_, x_, mu_, gq_, gmu_), (), chunk, 7)

    # #8, #9 on the DDM batch
    with torch.no_grad():
        fwd_args = (*grids, x, mu, wk0, bk0, cut, True)
        got = torch.cat(P.painn_message_fused(*fwd_args), dim=-1)
        errs.check("painn_fwd" + tag, got, plain_fwd(grids, x, mu, 16),
                   f"{what} sparse=True")
        if not torch.equal(got, torch.cat(P.painn_message_fused(*fwd_args),
                                          dim=-1)):
            fail(f"painn_fwd{tag}: outputs differ between two launches")
        row("painn_fwd", lambda: P.painn_message_fused(*fwd_args),
            lambda: plain_fwd(grids, x, mu, 16),
            painn_work("painn_fwd", grids, x, w, r), shape=what)
    check_painn_bwd(errs, grids, x, mu, wk0, bk0, gq, gmu, cut, what,
                    chunk=4 if big else 8, tag=tag)
    bwd_args = (*grids, x, mu, wk0, bk0, gq, gmu, cut, True)
    if not all(torch.equal(a, b) for a, b in zip(P.painn_bwd(*bwd_args),
                                                 P.painn_bwd(*bwd_args))):
        fail(f"painn_bwd{tag}: outputs differ between two launches")
    row("painn_bwd", lambda: P.painn_bwd(*bwd_args),
        lambda: plain_bwd(grids, x, mu, gq, gmu, 4 if big else 8),
        painn_work("painn_bwd", grids, x, w, r), shape=what)
    # #10, #11 on the LBA batch
    grids_l, q0_l, x_l, mu_l = painn_inputs(m, lba_batch)
    gq_l = torch.randn(q0_l.shape, generator=gen, device=dev)
    gmu_l = torch.randn(mu_l.shape, generator=gen, device=dev)
    chunk_l = 2 if big else 4
    with torch.no_grad():
        want_fwd = plain_fwd(grids_l, x_l, mu_l, chunk_l)
    want_bwd = plain_bwd(grids_l, x_l, mu_l, gq_l, gmu_l, chunk_l)
    check_painn_sym(errs, grids_l, x_l, mu_l, wk0, bk0, gq_l, gmu_l, cut,
                    f"LBA B=64 N=512 emb={w} R={r}", want_fwd, want_bwd,
                    tag=tag)
    del want_fwd, want_bwd
    row("painn_fwd_sym", lambda: P.painn_message_fused_sym(
        *grids_l, x_l, mu_l, wk0, bk0, cut, True),
        lambda: plain_fwd(grids_l, x_l, mu_l, chunk_l),
        painn_work("painn_fwd_sym", grids_l, x_l, w, r),
        shape=f"LBA B=64 N=512 emb={w} R={r}")
    row("painn_bwd_sym", lambda: P.painn_bwd_sym(
        *grids_l, x_l, mu_l, wk0, bk0, gq_l, gmu_l, cut, True),
        lambda: plain_bwd(grids_l, x_l, mu_l, gq_l, gmu_l, chunk_l),
        painn_work("painn_bwd_sym", grids_l, x_l, w, r),
        shape=f"LBA B=64 N=512 emb={w} R={r}")
    if big:
        return rows
    # #12: serving's first batch at N=32 (the row) and the DDM batch in
    # residual mode
    grids_s, q0_s, _, _ = painn_inputs(m, serve_batch)
    with torch.no_grad():
        got = P.painn_stack_infer(*grids_s, q0_s, stacked, cut)
        want = chunked_sum(lambda *a: P.painn_stack_reference(
            *a, stacked, cut), (*grids_s, q0_s), (), 32, 2)
        for name, a, b in zip(("q", "mu"), got, want):
            errs.check_scaled("painn_stack" + tag, a, b,
                              f"serving B=128 N=32 emb={w} R={r} {name}")
        if not all(torch.equal(a, b) for a, b in zip(
                got, P.painn_stack_infer(*grids_s, q0_s, stacked, cut))):
            fail(f"painn_stack{tag}: outputs differ between two launches")
        got = P._launch_painn_stack("painn_stack_train", grids, q0, stacked,
                                    cut, m.epsilon, True)
        want = chunked_sum(lambda *a: P.painn_stack_reference(
            *a, stacked, cut, save_residuals=True), (*grids, q0), (), 32, 6)
        for name, a, b in zip(("q", "mu", "qs", "mus", "qps", "mups"), got,
                              want):
            errs.check_scaled("painn_stack" + tag, a, b,
                              f"{what} residual mode {name}")
        del got, want
        b_s, n_s = q0_s.shape[:2]
        row("painn_stack", lambda: P.painn_stack_infer(*grids_s, q0_s,
                                                       stacked, cut),
            lambda: chunked_sum(lambda *a: P.painn_stack_reference(
                *a, stacked, cut), (*grids_s, q0_s), (), 32, 2),
            painn_work("painn_stack", grids_s, q0_s, w, r, layers, stacked,
                       int(serve_batch.node_mask.sum())),
            shape=f"serving B=128 N=32 emb={w} R={r}",
            stack_shape=(b_s, n_s, False, r))
    return rows


def painn_widths_step_times(dev, batch):
    """(d) The device ms of one DDM-PaiNN step at bucket 128 (a seeded
    module, traced after a warm-up) at 128/20 and each timed setting."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    out = {}
    for w, r in ((128, 20), *PAINN_ROW_TAGS):
        targs = PG.build_parser().parse_args(painn_flags(w, r))
        ddm = PG.make_ddm(targs, painn_cfg(w, r),
                          torch.Generator().manual_seed(SEED)).to(dev)
        opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(),
                                                     100)
        gen = torch.Generator(dev).manual_seed(SEED)

        def step():
            return PG.train_step(ddm, opt, sched, [batch], targs, gen)

        step()
        torch.cuda.synchronize()
        _, busy, ours = device_profile(step)
        out[f"emb={w} R={r}"] = {"device_ms": busy * 1e3,
                                 "port_kernels_ms": ours * 1e3}
        del ddm, opt
    return out


def painn_widths_path(dev, card, errs, store, buckets, first, packed,
                      train_batch, lba_batch):
    """Phase 8: PaiNN at emb_dim 256 (k = 2 column blocks) and 96 (padded)
    at R = 20, and at n_rbf 32 and 64 (streamed, 2 and 3 passes) at emb_dim
    128: (a) the main paths, (b) the steps against their plain steps, (c)
    #8-#12 against their plain versions (timed at 256/20, 96/20 and
    128/64: the kernel table's ``<kernel>_f256`` / ``_f96`` / ``_r64``
    rows, their launches (a)'s and (b)'s, bounds at the user's F and R,
    ptxas of the instance), (d) the DDM step's device ms. The layout of
    the filter passes is first held to the library's
    (``check_rbf_layout``). Returns the rows."""
    import torch

    t0 = time.time()
    check_rbf_layout()
    batch = train_batch(128)
    serve_batch = packed(first(32, 128), 32, 128)
    rows, launches, calls = [], {}, {}
    for w, r in PAINN_SETTINGS:
        counts, main_calls = painn_widths_main_path(dev, w, r, store,
                                                    buckets, first, packed)
        steps, step_calls = painn_widths_steps(dev, w, r, batch, lba_batch)
        launches[(w, r)] = {n: counts[n] + steps[n] for n in counts}
        calls[(w, r)] = {d: main_calls[d] + step_calls[d]
                         for d in main_calls}
        for name, src, replaces, ms, plain_ms, flops, nbytes, extra in \
                painn_widths_kernels(dev, errs, w, r, batch, lba_batch,
                                     serve_batch, (w, r) in PAINN_ROW_TAGS):
            kernel = name[:-len(PAINN_ROW_TAGS[(w, r)])]
            rows.append((name, src, replaces, ms, plain_ms, flops, nbytes,
                         launches[(w, r)][kernel], extra))
        torch.cuda.empty_cache()
    steps = painn_widths_step_times(dev, batch)
    seconds = time.time() - t0
    print("painn_widths: " + json.dumps({
        "card": card, "seconds": seconds,
        "ddm_step_bucket_128": steps,
        "launches": {f"emb={w} R={r}": {k: v for k, v in c.items() if v}
                     for (w, r), c in launches.items()},
        "message_calls": {f"emb={w} R={r}": c for (w, r), c in calls.items()},
        "rows": {name: {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(flops, nbytes),
                        "launches": count, **extra}
                 for name, _, _, ms, plain_ms, flops, nbytes, count, extra
                 in rows}}))
    if seconds > PAINN_WIDTH_BUDGET_S:
        fail(f"painn_widths: {seconds:.1f} s, above its "
             f"{PAINN_WIDTH_BUDGET_S:.0f} s")
    return rows


# -- Phase 9: the last width refusals ---------------------------------------------
# The two settings a training driver refused on CUDA until their kernels took
# them: the bf16 CFConv backwards (#2/#4) above F = 128, in their
# hidden-block instance (csrc/cfconv_bwd_bf16w.cu, counted as
# <kernel>_bf16w, k = ceil(F / 128) launches a call), and the DDM head
# (#6/#7) above E = 256, in its streamed instance (csrc/ncsn_score_wide.cu,
# counted as <kernel>_wide). Tolerances: phase 6's for the bf16 instances and
# the bf16 steps, phase 2's for the head, 1e-3 (GRAD_RTOL) for the f32 steps.
FINAL_BUDGET_S = 120.0
FINAL_KERNELS = {
    "cfconv_bwd": ("geossl_tpu_torch/ops/csrc/cfconv_bwd_bf16w.cu",
                   "geossl_tpu/ops/cfconv_pallas.py:150"),
    "cfconv_bwd_sym": ("geossl_tpu_torch/ops/csrc/cfconv_bwd_bf16w.cu",
                       "geossl_tpu/ops/cfconv_pallas.py:464"),
    "ncsn_score_fwd": ("geossl_tpu_torch/ops/csrc/ncsn_score_wide.cu",
                       "geossl_tpu/ops/ncsn_pallas.py:67"),
    "ncsn_score_bwd": ("geossl_tpu_torch/ops/csrc/ncsn_score_wide.cu",
                       "geossl_tpu/ops/ncsn_pallas.py:135"),
}
# the slice's commands: (tag, driver, flags, {counter: launches a call}) of
# the new instances each must launch (a DDM step makes 2 views x L calls of
# the backward and 2 head calls each way; an LBA step L calls)
FINAL_COMMANDS = (
    ("DDM-SchNet emb=F=512", "pretrain_geossl",
     ["--emb_dim", "512", "--num_filters", "512"],
     {"ncsn_score_fwd_wide": 0, "ncsn_score_bwd_wide": 0}),
    ("DDM-PaiNN emb=384", "pretrain_geossl",
     ["--model_3d", "painn", "--emb_dim", "384"],
     {"ncsn_score_fwd_wide": 0, "ncsn_score_bwd_wide": 0}),
    ("DDM-SchNet emb=F=256 compute_dtype", "pretrain_geossl",
     ["--emb_dim", "256", "--num_filters", "256", *BF16_FLAGS["compute_dtype"]],
     {"cfconv_bwd_sym_bf16w": 2}),
    ("DDM-SchNet emb=F=256 filter_mxu max_neighbors=32", "pretrain_geossl",
     ["--emb_dim", "256", "--num_filters", "256", *BF16_FLAGS["filter_mxu"],
      "--max_num_neighbors", "32"],
     {"cfconv_bwd_bf16w": 2}),
    ("LBA-SchNet F=384 filter_mxu", "finetune_lba",
     ["--num_filters", "384", *BF16_FLAGS["filter_mxu"]],
     {"cfconv_bwd_sym_bf16w": 3}),
)
# the DDM commands' synthetic epoch: molecules, their most atoms
FINAL_SYNTHETIC = (128, 100)
# (F, G, timed) of #2/#4's hidden-block instance against its plain version
FINAL_BF16W = ((256, 51, True), (256, 300, False), (384, 51, False),
               (384, 300, False))
# (E, timed) of #6/#7's streamed instance against its plain version
FINAL_HEADS = ((300, False), (384, True), (512, True))


def final_run(dev, tag, driver, flags, per_call):
    """One epoch of ``driver`` with ``flags`` (DDM: 128 synthetic molecules
    over buckets 32/64/128, batch 128; LBA: one step at B=64, N=512),
    counters reset before and read after: each counter of ``per_call``
    moves by its launches a call (0: two head calls a step each way) times
    the step's calls, and the replaced instances do not launch. Returns
    (the counts, the steps)."""
    import math

    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import pretrain_geossl as PG

    run_dir = os.path.join(ROOT, "runs", "chip_smoke_final")
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_launch_counts()
    if driver == "pretrain_geossl":
        argv = ["--synthetic", "--synthetic_size", str(FINAL_SYNTHETIC[0]),
                "--synthetic_max_atoms", str(FINAL_SYNTHETIC[1]),
                "--epochs", "1", "--output_model_dir", run_dir, *flags]
        _, losses = PG.main(argv)
        args = PG.build_parser().parse_args(argv)
        calls = 2 * common.model_config_from_args(args).schnet.num_interactions
    else:
        argv = [*lba_flags("schnet"), "--output_model_dir", run_dir, *flags]
        _, best, _, losses = FL.main(argv)
        args = FL.build_parser().parse_args(argv)
        calls = common.model_config_from_args(args).schnet.num_interactions
        if not math.isfinite(best):
            fail(f"{tag}: best {best}")
    counts = launch_counts()
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: losses {losses}")
    steps = len(losses)
    for name, k in per_call.items():
        want = (k * calls if k else 2) * steps
        if counts[name] != want:
            fail(f"{tag}: {counts[name]} launches of {name}, want {want}")
    # the instances the new ones stand in for at these widths
    replaced = [n[:-1] for n in per_call if n.endswith("_bf16w")]
    if "ncsn_score_fwd_wide" in per_call:
        replaced += [n + e for n in ("ncsn_score_fwd", "ncsn_score_bwd")
                     for e in ("", "_e256")]
    for old in replaced:
        if counts[old]:
            fail(f"{tag}: {counts[old]} launches of {old}")
    print(f"widths_final run {tag}: {steps} steps, launches "
          f"{ {n: v for n, v in counts.items() if v} }")
    return counts, steps


def final_steps(dev, batch, lba_batch):
    """(b) One step per command at bucket 128 (LBA: B=64, N=512) against
    the same step through the plain versions, in graph chunks: the f32
    steps within RTOL / GRAD_RTOL, the bf16 steps within phase 6's step
    tolerance."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import pretrain_geossl as PG

    cat = lambda gs: torch.cat([t.flatten() for t in gs.values()])  # noqa: E731
    for tag, driver, flags, _ in FINAL_COMMANDS:
        bf16 = any(f in flags for f in ("bf16", "bfloat16"))
        if driver == "pretrain_geossl":
            targs = PG.build_parser().parse_args(flags)
            cfg = common.model_config_from_args(targs)
            net = PG.make_ddm(targs, cfg,
                              torch.Generator().manual_seed(SEED)).to(dev)
            pos2, sel, draws = step_draws(net, batch, targs, 128)
            loss_k, grads_k = ddm_grads(net, batch, pos2, sel, draws)
            net.plain = True
            loss_p, grads_p = ddm_grads(net, batch, pos2, sel, draws,
                                        chunk=max(2, 16 * 128 // cfg.emb_dim))
        else:
            args = FL.build_parser().parse_args([*lba_flags("schnet"),
                                                 *flags])
            net = FL.make_net(args, common.model_config_from_args(args),
                              torch.Generator().manual_seed(SEED)).to(dev)

            def loss(sb, sl):
                return FL.loss_fn(net, sb)

            loss_k, grads_k = grads_in_chunks(net, lba_batch, loss)
            net.plain = True
            loss_p, grads_p = grads_in_chunks(net, lba_batch, loss, chunk=2)
        what = f"widths_final {tag} step parity"
        if not bf16:
            check_step_parity(what, loss_k, grads_k, loss_p, grads_p)
        else:
            rel = rel_norm(cat(grads_k), cat(grads_p))
            if abs(loss_k - loss_p) > BF16_STEP_LOSS * abs(loss_p) or \
                    rel > BF16_STEP_NORM:
                fail(f"{what}: loss {loss_k} vs plain {loss_p}, gradients "
                     f"rel_norm {rel:.3e}")
            print(f"{what}: loss {loss_k:.6f} vs {loss_p:.6f}, gradient "
                  f"rel_norm {rel:.3e}")
        del net
        torch.cuda.empty_cache()


def final_forces(dev, cfg, store, first):
    """(a) ``Predictor.predict_forces`` on a seeded bf16 (``--filter_mxu
    bf16``) SchNet at num_filters 256, two complexes at N=512 (the
    symmetric pair's bf16 backward in its hidden-block instance), against
    the plain forces: energies within phase 6's output bound, forces
    within its gradient bound."""
    import torch

    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train.common import make_backbone, make_head

    cw = bf16_cfg(width_cfg(cfg, 256), "filter_mxu")
    gen = torch.Generator().manual_seed(SEED)
    state = {"model": make_backbone(cw, gen).state_dict(),
             "graph_pred_linear": make_head("schnet", 256, gen).state_dict(),
             "y_mean": 1.5, "y_std": 2.0}
    pred = Predictor(cw, state, batch_size=128, bucket_sizes=(512,))
    forces_store = store.select(first(512, 2))
    energies, forces = pred.predict_forces(forces_store)
    torch.cuda.synchronize()
    e_p, f_p = plain_forces(pred, forces_store)
    e = torch.as_tensor(energies, device=e_p.device)
    f = torch.as_tensor(forces, device=f_p.device)
    atol = BF16_ATOL * e_p.abs().max().item()
    rel = rel_norm(f, f_p)
    mean = (f - f_p).abs().mean().item() / (f_p.abs().mean().item() + 1e-30)
    if not torch.isfinite(f).all() or f.shape != f_p.shape or \
            not (e - e_p).abs().le(atol + BF16_RTOL * e_p.abs()).all() or \
            rel > BF16_GRAD_NORM or mean > BF16_GRAD_MEAN:
        fail(f"widths_final predict_forces bf16 F=256: energies max_abs_err "
             f"{(e - e_p).abs().max().item():.3e}, forces rel_norm {rel:.3e},"
             f" mean {mean:.3e}")
    print(f"widths_final predict_forces bf16 F=256 (2 complexes, N=512): "
          f"energies max_abs_err {(e - e_p).abs().max().item():.3e}, forces "
          f"rel_norm {rel:.3e}, mean_abs_err {mean:.3e} of the mean")


def final_step_times(dev, batch):
    """(d) The device ms of one DDM step at bucket 128 per DDM command of
    the phase (a seeded module, traced after a warm-up)."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    out = {}
    for tag, driver, flags, _ in FINAL_COMMANDS:
        if driver != "pretrain_geossl":
            continue
        targs = PG.build_parser().parse_args(flags)
        ddm = PG.make_ddm(targs, common.model_config_from_args(targs),
                          torch.Generator().manual_seed(SEED)).to(dev)
        opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(),
                                                     100)
        gen = torch.Generator(dev).manual_seed(SEED)

        def step():
            return PG.train_step(ddm, opt, sched, [batch], targs, gen)

        step()
        torch.cuda.synchronize()
        _, busy, ours = device_profile(step)
        out[tag] = {"device_ms": busy * 1e3, "port_kernels_ms": ours * 1e3}
        del ddm, opt
    return out


def final_widths_path(dev, card, errs, cfg, cutoff, cases, store, first,
                      train_batch, lba_batch):
    """Phase 9: the slice's five commands at the widths the drivers once
    refused (counters reset before each and read after: their sums are the
    rows' launches), ``predict_forces`` on a bf16 F = 256 model, each
    command's step against its plain step, the new instances against their
    plain versions (#2/#4 bf16 at F = 256 and 384, G = 51 and 300; #6/#7 at
    E = 300, 384 and 512, two launches bitwise equal; timed at F = 256 and
    E = 384 / 512: the kernel table's ``<kernel>_bf16w_f256`` and
    ``<kernel>_wide_e384`` / ``_e512`` rows), their shared memory (the
    query, constant in F and E, and ptxas), and the DDM step's device ms
    per command. Returns the rows."""
    import ctypes

    import torch

    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.utils import flops

    t0 = time.time()
    batch = train_batch(128)
    launches = {}
    runs = {}
    for tag, driver, flags, per_call in FINAL_COMMANDS:
        counts, steps = final_run(dev, tag, driver, flags, per_call)
        runs[tag] = steps
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v
    reset_launch_counts()
    final_forces(dev, cfg, store, first)
    forces_counts = launch_counts()
    if forces_counts["cfconv_bwd_sym_bf16w"] == 0:
        fail("widths_final predict_forces: cfconv_bwd_sym_bf16w not launched")
    for n, v in forces_counts.items():
        launches[n] = launches.get(n, 0) + v
    for name in ("cfconv_bwd_bf16w", "cfconv_bwd_sym_bf16w",
                 "ncsn_score_fwd_wide", "ncsn_score_bwd_wide"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on phase 9's paths")
    t_main = time.time() - t0
    final_steps(dev, batch, lba_batch)
    t_steps = time.time() - t0 - t_main
    rows = []
    for w, g, timed in FINAL_BF16W:
        wcases, cw = widen_cases(dev, cases, w), width_cfg(cfg, w)
        if not timed:  # the LBA shape on 8 of its 64 complexes
            wcases["lba"] = tuple(t[:8] for t in wcases["lba"])
        tag = f"_bf16w_f{w}" + ("" if g == 51 else f"_g{g}")
        for name, src, replaces, ms, plain_ms, work, nbytes, extra in \
                bf16_kernels(dev, errs, g, wcases, cw, cutoff, timed, tag=tag,
                             forward=False):
            counter = name[:-len(tag)] + "_bf16w"
            rows.append((name, src, replaces, ms, plain_ms, work, nbytes,
                         launches[counter], {
                             **extra, "width": w, "launches_per_call":
                             flops.cfconv_launches(w, True, "bf16")}))
        del wcases
        torch.cuda.empty_cache()
    for e, timed in FINAL_HEADS:
        tag = f"_wide_e{e}"
        for name, src, replaces, ms, plain_ms, work, nbytes, extra in \
                widths_ncsn(dev, errs, e, cfg, batch, tag, timed):
            counter = name[:-len(tag)] + "_wide"
            rows.append((name, src, replaces, ms, plain_ms, work, nbytes,
                         launches[counter], {**extra, "width": e,
                                             "launches_per_call": 1}))
        torch.cuda.empty_cache()
    t_kernels = time.time() - t0 - t_main - t_steps
    steps = final_step_times(dev, batch)
    smem = {
        "cfconv_bwd_bf16w": {
            f"N={n}": _build.kernel_fn("cfconv_bwd_bf16w",
                                       "cfconv_bwd_bf16w_smem_bytes",
                                       [ctypes.c_int], ctypes.c_size_t)(n)
            for n in (128, 512)},
        "ncsn_score_wide": _build.kernel_fn(
            "ncsn_score_wide", "ncsn_wide_smem_bytes", [],
            ctypes.c_size_t)()}
    ptxas = {
        **{f"cfconv_bwd{'_sym' if sym else ''}_bf16w"
           f"{'_g300' if big else ''}": ptxas_usage(
               _build.build_log("cfconv_bwd_bf16w"),
               f"_ZN6geossl5bf16w23cfconv_bwd_bf16w_kernelILb{int(sym)}"
               f"ELb{int(big)}E")
           for sym in (False, True) for big in (False, True)},
        **{f"ncsn_score_{d}_wide": ptxas_usage(
            _build.build_log("ncsn_score_wide"),
            f"_ZN6geossl5nwide20ncsn_wide_{d}_kernel")
           for d in ("fwd", "bwd")}}
    seconds = time.time() - t0
    print("widths_final: " + json.dumps({
        "card": card, "seconds": seconds,
        "seconds_by_part": {"commands": t_main, "steps": t_steps,
                            "kernels": t_kernels,
                            "step_times": seconds - t_main - t_steps
                            - t_kernels},
        "commands": runs, "ddm_step_bucket_128": steps,
        "smem_bytes": smem, "ptxas": ptxas,
        "launches": {n: v for n, v in launches.items()
                     if v and ("bf16w" in n or "wide" in n)},
        "rows": {name: {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(work, nbytes, PEAK_BF16_FLOPS
                                             if extra.get("mxu") == "bf16"
                                             else PEAK_TF32_FLOPS),
                        "launches": count, **extra}
                 for name, _, _, ms, plain_ms, work, nbytes, count, extra
                 in rows}}))
    if seconds > FINAL_BUDGET_S:
        fail(f"widths_final: {seconds:.1f} s, above its "
             f"{FINAL_BUDGET_S:.0f} s")
    return rows



def rel_norm(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def refuses_grad(fn):
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        import geossl_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"geossl_tpu_torch is not importable ({e}); run from the repo root")
    # the whole output also goes to runs/chip_smoke.log (git-ignored), for
    # callers that keep only the end of the console output
    log_dir = os.path.join(ROOT, "runs")
    os.makedirs(log_dir, exist_ok=True)
    log = open(os.path.join(log_dir, "chip_smoke.log"), "w")
    sys.stdout = _Tee(sys.__stdout__, log)
    sys.stderr = _Tee(sys.__stderr__, log)
    import numpy as np

    import math

    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.data.bucketing import assign_buckets, pack_batch
    from geossl_tpu_torch.data.molecule3d import load_molecule3d
    from geossl_tpu_torch.data.store import MolStore
    from geossl_tpu_torch.data.synthetic import synthetic_lba, synthetic_molecule3d
    from geossl_tpu_torch.models.common import cosine_cutoff
    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.ops import ncsn as NS
    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch import serve
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.data.bucketing import BucketedLoader
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import finetune_lep as FE
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone, make_head

    # -- 1. card and build --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed ({smi.returncode})"
    print(f"card: {card}")
    dev = torch.device("cuda")
    t0 = time.time()
    reports = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s for {sorted(reports) or 'cached'}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    K.plain_precision()

    # -- data and weights -----------------------------------------------------
    mols = synthetic_molecule3d(512, seed=1, max_atoms=100)
    lba = synthetic_lba(32, seed=2, max_atoms=400)
    records = [mols.get(i) for i in range(len(mols))] + \
        [lba.get(i) for i in range(len(lba))]
    for r in records:
        r.y = None  # the two stores label differently; serving needs none
    store = MolStore.from_records(records)
    buckets = (32, 64, 128, 256, 512)
    gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig()
    cfg_mn = ModelConfig(max_neighbors=32)
    state = {"model": make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": make_head("schnet", cfg.emb_dim, gen).state_dict(),
             "y_mean": 1.5, "y_std": 2.0}
    pred = Predictor(cfg, state, batch_size=128, bucket_sizes=buckets)
    pred_mn = Predictor(cfg_mn, state, batch_size=128, bucket_sizes=buckets)
    model, model_mn = pred.model, pred_mn.model
    sorted_store = pred._maybe_sort(store)  # as the Predictor sees it
    bucket_of = assign_buckets(sorted_store.num_atoms(), buckets)
    missing = [b for b in buckets if not (bucket_of == b).any()]
    if missing:
        fail(f"store leaves buckets {missing} empty")
    G, cutoff = cfg.schnet.num_gaussians, cfg.schnet.cutoff
    # PaiNN at its published width, seeded random weights and head
    cfg_p = ModelConfig(model_3d="painn")
    gen_p = torch.Generator().manual_seed(SEED)
    state_p = {"model": make_backbone(cfg_p, gen_p).state_dict(),
               "graph_pred_linear": make_head("painn", cfg_p.emb_dim,
                                              gen_p).state_dict(),
               "y_mean": 1.5, "y_std": 2.0}
    pred_p = Predictor(cfg_p, state_p, batch_size=128, bucket_sizes=buckets)
    model_p = pred_p.model
    cut_p = cfg_p.painn.cutoff

    @torch.inference_mode()
    def layer0_inputs(m, idx, n, batch_size=None):
        """dist, env, h0 and block 0's x for molecules idx packed at n."""
        batch = pack_batch([sorted_store.get(int(i)) for i in idx], n,
                           batch_size).to(dev)
        dist, adj = m.geometry(batch.positions, batch.node_mask)
        env = m.envelope(dist, adj)
        h0 = m.embedding(batch.atom_type)
        x = m.interactions[0].conv.lin1(h0)
        return batch, dist.contiguous(), env.contiguous(), h0.contiguous(), x.contiguous()

    def first(b, k):
        return np.nonzero(bucket_of == b)[0][:k]

    def packed(idx, n, batch_size=None):
        return pack_batch([sorted_store.get(int(i)) for i in idx], n,
                          batch_size).to(dev)

    # -- 2. kernel parity -----------------------------------------------------
    errs = Errors()

    def check_stack(idx, n, what, batch_size=None):
        """schnet_stack in both modes against the plain stack: symmetric on
        the default graph, plain mode on the max_neighbors=32 graph; then a
        second launch against the first (its messages are summed with
        atomics: the same tolerance)."""
        for m, sym in ((model, True), (model_mn, False)):
            _, dist, env, h0, _ = layer0_inputs(m, idx, n, batch_size)
            tag = f"{what} symmetric={sym}"
            want = chunked(K.schnet_stack_reference, (dist, env, h0),
                           (stacked, 0.0, cutoff, G), 32)
            got = K.schnet_stack(dist, env, h0, stacked, 0.0, cutoff, G, sym)
            errs.check("schnet_stack", got, want, tag)
            errs.check("schnet_stack", K.schnet_stack(
                dist, env, h0, stacked, 0.0, cutoff, G, sym), got,
                f"{tag} second launch")

    with torch.inference_mode():
        stacked = model.stacked_weights()
        # (bucket, pad): the buckets, plus a pad that is no multiple of the
        # kernels' 8-atom tile (molecules of bucket 128 have <= 100 atoms);
        # then serving's first batch of each stack bucket (128 slots), a
        # partial batch (5 real graphs in 128 slots) and one of very uneven
        # graphs (60 of bucket 32 and 8 of bucket 128, padded to 128 atoms)
        for b, n in ((32, 32), (128, 128), (128, 100)):
            check_stack(first(b, 8), n, f"B=8 N={n}")
        for b in (32, 64, 128):
            check_stack(first(b, 128), b, f"serving B=128 N={b}", 128)
        check_stack(first(128, 5), 128, "partial B=128 (5 graphs) N=128", 128)
        check_stack(np.concatenate([first(32, 60), first(128, 8)]), 128,
                    "uneven B=128 (60 + 8 graphs) N=128", 128)
        filt = model.interactions[0].filter_weights()
        filt_mn = model_mn.interactions[0].filter_weights()
        for name, m, fw, fn, sizes in (
                ("cfconv_fwd", model_mn, filt_mn, K.cfconv_fused,
                 ((128, 128), (256, 256), (128, 100))),
                ("cfconv_fwd_sym", model, filt, K.cfconv_fused_sym,
                 ((256, 256), (512, 512), (128, 132)))):
            for b, n in sizes:
                _, dist, env, _, x = layer0_inputs(m, first(b, 2), n)
                want = K.cfconv_fused_reference(dist, env, x, *fw, 0.0, cutoff, G)
                for sp in (False, True):
                    errs.check(name, fn(dist, env, x, *fw, 0.0, cutoff, G, sp),
                               want, f"B=2 N={n} sparse={sp}")
        # the plain mode above G = 64 (W1 streamed in chunks of 32 rows):
        # G = 100 on the same max_neighbors graphs, a second launch against
        # the first
        g_big = 100
        fw_big = ((torch.randn(g_big, cfg.emb_dim, generator=torch.Generator().manual_seed(SEED))
                   / 10).to(dev), *filt_mn[1:])
        for b, n in ((128, 128), (256, 256)):
            _, dist, env, _, x = layer0_inputs(model_mn, first(b, 2), n)
            want = K.cfconv_fused_reference(dist, env, x, *fw_big, 0.0, cutoff, g_big)
            for sp in (False, True):
                got = K.cfconv_fused(dist, env, x, *fw_big, 0.0, cutoff, g_big, sp)
                errs.check("cfconv_fwd", got, want, f"B=2 N={n} G={g_big} sparse={sp}")
                if not torch.equal(got, K.cfconv_fused(dist, env, x, *fw_big, 0.0,
                                                       cutoff, g_big, sp)):
                    fail(f"cfconv_fwd B=2 N={n} G={g_big} sparse={sp}: outputs "
                         "differ between two launches")
        # the symmetric kernel's work list on a partial batch (5 real graphs
        # in 128 slots) and on very uneven graphs (60 of bucket 32 and 8 of
        # bucket 128 at N=128); a second launch against the first (its
        # messages are summed with atomics: the same tolerance)
        for idx, what in ((first(128, 5), "partial B=128 (5 graphs) N=128"),
                          (np.concatenate([first(32, 60), first(128, 8)]),
                           "uneven B=128 (60 + 8 graphs) N=128")):
            _, dist, env, _, x = layer0_inputs(model, idx, 128, 128)
            want = chunked(K.cfconv_fused_reference, (dist, env, x),
                           (*filt, 0.0, cutoff, G), 16)
            for sp in (False, True):
                got = K.cfconv_fused_sym(dist, env, x, *filt, 0.0, cutoff, G, sp)
                errs.check("cfconv_fwd_sym", got, want, f"{what} sparse={sp}")
                errs.check("cfconv_fwd_sym", K.cfconv_fused_sym(
                    dist, env, x, *filt, 0.0, cutoff, G, sp), got,
                    f"{what} sparse={sp} second launch")

    # the backward kernels and the NCSN head, outside inference mode (the
    # plain versions differentiate with autograd). Every check of a kernel
    # against its plain version runs on this freshly seeded DDM model (the
    # trained one differs from run to run in its last digits), so that which
    # pre-activations sit within rounding of a relu's kink, where kernel and
    # plain version may take different sides, is the same in every run.
    targs = PG.build_parser().parse_args([])
    ddm0 = PG.make_ddm(targs, cfg, torch.Generator().manual_seed(SEED)).to(dev)
    # the same, seeded alike, on the max_neighbors=32 graph: the plain-mode
    # CFConv pair's training path
    ddm0_mn = PG.make_ddm(targs, cfg_mn,
                          torch.Generator().manual_seed(SEED)).to(dev)
    gen_g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        filt_g = model.interactions[0].filter_weights()
    # the plain-mode backward on the graph of its path (max_neighbors=32:
    # env truncated, not symmetric)
    for b, n in ((32, 32), (128, 128), (128, 100)):
        _, dist, env, _, x = layer0_inputs(model_mn, first(b, 8), n)
        dist, env, x = dist.clone(), env.clone(), x.clone()
        g = torch.randn(x.shape, generator=gen_g).to(dev)
        check_cfconv_bwd(errs, dist, env, x, g, filt_g, G, cutoff, f"B=8 N={n}")
    # the symmetric backward on LBA complexes: the buckets of its path and
    # a pad that is no multiple of the 8-atom tile
    for b, n in ((256, 256), (512, 512), (256, 260)):
        _, dist, env, _, x = layer0_inputs(model, first(b, 2), n)
        dist, env, x = dist.clone(), env.clone(), x.clone()
        g = torch.randn(x.shape, generator=gen_g).to(dev)
        check_cfconv_bwd_sym(errs, dist, env, x, g, filt_g, G, cutoff,
                             f"B=2 N={n}")
    for b in (32, 128):
        batch = pack_batch([sorted_store.get(int(i)) for i in first(b, 8)],
                           b).to(dev)
        grid, weights, anneal = ncsn_inputs(ddm0, batch, targs, SEED)
        check_ncsn(errs, grid, weights, anneal, f"B=8 N={b}")

    # PaiNN's kernels: the message pass and its backward at the buckets, a
    # pad that is no multiple of 8 and N=256 (gating on and off), the whole
    # stack against the per-block plain chain
    with torch.no_grad():
        wk_p, bk_p = model_p.filter_weights()[0]
        stacked_p = model_p.stacked_weights()
    gen_g = torch.Generator(dev).manual_seed(SEED)
    for b, n, k in ((32, 32, 8), (128, 128, 8), (128, 100, 8), (256, 256, 2)):
        grids, q0, x, mu = painn_inputs(model_p, packed(first(b, k), n))
        with torch.no_grad():
            want = P.painn_message_reference(*grids, x, mu, wk_p, bk_p, cut_p)
            for sp in (False, True):
                got = P.painn_message_fused(*grids, x, mu, wk_p, bk_p, cut_p, sp)
                for name, a, w in zip(("dq", "dmu"), got, want):
                    errs.check("painn_fwd", a, w,
                               f"B={k} N={n} sparse={sp} {name}")
        gq = torch.randn(q0.shape, generator=gen_g, device=dev)
        gmu = torch.randn(mu.shape, generator=gen_g, device=dev)
        check_painn_bwd(errs, grids, x, mu, wk_p, bk_p, gq, gmu, cut_p,
                        f"B={k} N={n}")
        if n <= P.STACK_MAX_N:
            with torch.no_grad():
                want = P.painn_stack_reference(*grids, q0, stacked_p, cut_p)
                got = P.painn_stack_infer(*grids, q0, stacked_p, cut_p)
            for name, a, w in zip(("q", "mu"), got, want):
                errs.check_scaled("painn_stack", a, w, f"B={k} N={n} {name}")

    # -- 3a. main path: serving ---------------------------------------------------
    reset_launch_counts()
    t0 = time.time()
    preds = pred.predict(store)
    emb = pred.embed(store)
    preds_mn = pred_mn.predict(store)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path (serving): {len(store)} molecules x 3 passes in "
          f"{time.time() - t0:.2f} s (first call); launches {launches}")
    for name in ("cfconv_fwd", "cfconv_fwd_sym", "schnet_stack"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the serving path")
    if preds.shape != (len(store),) or emb.shape != (len(store), cfg.emb_dim):
        fail(f"output shapes {preds.shape}, {emb.shape}")
    for what, arr in (("predict", preds), ("embed", emb),
                      ("predict max_neighbors=32", preds_mn)):
        if not np.isfinite(arr).all():
            fail(f"{what}: non-finite output")

    with torch.inference_mode():
        for b in buckets:
            idx = first(b, 8)
            for what, p, m, got_pred in (("default", pred, model, preds),
                                         ("max_neighbors=32", pred_mn, model_mn,
                                          preds_mn)):
                batch, *_ = layer0_inputs(m, idx, b)
                graph, _ = m(batch.atom_type, batch.positions, batch.node_mask,
                             plain=True)
                want_pred = (p.head(graph) * p.y_std + p.y_mean).cpu().numpy()
                # the store order is kept by the sort, so idx indexes both
                if not np.allclose(got_pred[idx], want_pred, rtol=RTOL, atol=ATOL):
                    fail(f"predict {what} bucket {b}: kernel path vs plain path, "
                         f"max_abs_err {np.abs(got_pred[idx] - want_pred).max():.3e}")
                if what == "default" and not np.allclose(
                        emb[idx], graph.cpu().numpy(), rtol=RTOL, atol=ATOL):
                    fail(f"embed bucket {b}: kernel path vs plain path")
            print(f"serve parity bucket {b}: {len(idx)} molecules agree with "
                  "the plain path (predict, embed, max_neighbors=32 predict)")

    # -- 3a'. main path: PaiNN serving ------------------------------------------
    reset_launch_counts()
    t0 = time.time()
    preds_p = pred_p.predict(store)
    emb_p = pred_p.embed(store)
    torch.cuda.synchronize()
    launches_p = launch_counts()
    print(f"main path (PaiNN serving): {len(store)} molecules x 2 passes in "
          f"{time.time() - t0:.2f} s (first call); launches {launches_p}")
    for name in ("painn_stack", "painn_fwd_sym"):
        if launches_p[name] == 0:
            fail(f"kernel {name} was not launched on the PaiNN serving path")
    if preds_p.shape != (len(store),) or \
            emb_p.shape != (len(store), cfg_p.emb_dim):
        fail(f"PaiNN output shapes {preds_p.shape}, {emb_p.shape}")
    if not (np.isfinite(preds_p).all() and np.isfinite(emb_p).all()):
        fail("PaiNN serving: non-finite output")
    with torch.inference_mode():
        for b in buckets:
            idx = first(b, 8)
            batch = packed(idx, b)
            graph, _ = model_p(batch.atom_type, batch.positions,
                               batch.node_mask, plain=True)
            want_pred = (pred_p.head(graph) * pred_p.y_std
                         + pred_p.y_mean).cpu().numpy()
            graph = graph.cpu().numpy()
            for what, got, want in (("predict", preds_p[idx], want_pred),
                                    ("embed", emb_p[idx], graph)):
                if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"PaiNN {what} bucket {b}: kernel path vs plain "
                         f"path, max_abs_err {np.abs(got - want).max():.3e}")
            print(f"PaiNN serve parity bucket {b}: {len(idx)} molecules agree "
                  "with the plain path (predict, embed)")

    # -- 3b. main path: DDM pretraining ----------------------------------------------
    out_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    train_argv = ["--synthetic", "--synthetic_size", "1024",
                  "--synthetic_max_atoms", "100", "--epochs", "1",
                  "--output_model_dir", out_dir]
    reset_launch_counts()
    t0 = time.time()
    ddm, losses = PG.main(train_argv)
    torch.cuda.synchronize()
    train_launches = launch_counts()
    print(f"main path (training): {len(losses)} steps of one epoch in "
          f"{time.time() - t0:.2f} s (first call); launches {train_launches}")
    # SchNet's dispatcher routes symmetric dist/env to the symmetric pair
    for name in ("cfconv_fwd_sym", "cfconv_bwd_sym", "ncsn_score_fwd",
                 "ncsn_score_bwd"):
        if train_launches[name] == 0:
            fail(f"kernel {name} was not launched on the training path")
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"training losses {losses}")
    print(f"training losses: {losses}")
    train_store = load_molecule3d("", synthetic=True, synthetic_size=1024,
                                  synthetic_max_atoms=100)
    train_buckets = (32, 64, 128)
    tbucket = assign_buckets(train_store.num_atoms(), train_buckets)
    if not all((tbucket == b).any() for b in train_buckets):
        fail("the training store leaves a bucket empty")
    emb_t = Predictor.from_checkpoint(
        os.path.join(out_dir, "model.pth"), batch_size=128,
        bucket_sizes=train_buckets).embed(train_store)
    if emb_t.shape != (len(train_store), cfg.emb_dim) or \
            not np.isfinite(emb_t).all():
        fail(f"Predictor on model.pth: shape {emb_t.shape} or non-finite")
    print(f"model.pth loads into a Predictor: {emb_t.shape[0]} finite embeddings")

    # -- 3b*. main path: DDM-SchNet on a max_num_neighbors graph --------------
    # the truncated graph is not symmetric, so SchNet takes the plain-mode
    # kernels at every bucket: a few steps of the same driver
    out_dir_mn = os.path.join(ROOT, "runs", "chip_smoke_mn")
    shutil.rmtree(out_dir_mn, ignore_errors=True)
    reset_launch_counts()
    t0 = time.time()
    _, losses_mn = PG.main(["--synthetic", "--synthetic_size", "384",
                            "--synthetic_max_atoms", "100", "--epochs", "1",
                            "--max_num_neighbors", "32",
                            "--output_model_dir", out_dir_mn])
    torch.cuda.synchronize()
    mn_launches = launch_counts()
    print(f"main path (training, max_num_neighbors=32): {len(losses_mn)} "
          f"steps in {time.time() - t0:.2f} s (first call); launches "
          f"{mn_launches}")
    for name in ("cfconv_fwd", "cfconv_bwd", "ncsn_score_fwd", "ncsn_score_bwd"):
        if mn_launches[name] == 0:
            fail(f"kernel {name} was not launched on the max_num_neighbors "
                 "training path")
    if not losses_mn or not all(math.isfinite(v) for v in losses_mn):
        fail(f"max_num_neighbors training losses {losses_mn}")

    def train_batch(b):
        idx = np.nonzero(tbucket == b)[0][:128]
        return pack_batch([train_store.get(int(i)) for i in idx], b, 128).to(dev)

    for b in train_buckets:
        step_parity(ddm0, train_batch(b), targs, b)
    step_parity(ddm0_mn, train_batch(128), targs, 128,
                "SchNet max_neighbors=32")
    # the symmetric CFConv is differentiable on the card: a gradient flows
    # through cfconv_bwd_sym to x and the filter weights; a second order
    # raises
    _, d256, e256, _, x256 = layer0_inputs(model, first(256, 2), 256)
    d256, e256 = d256.clone(), e256.clone()
    ins = [x256.clone().requires_grad_(True)] + \
        [w.detach().clone().requires_grad_(True) for w in filt_g]
    before = K.cfconv_bwd_sym.launches
    K.cfconv_fused_sym(d256, e256, *ins, 0.0, cutoff, G,
                       True).square().sum().backward()
    torch.cuda.synchronize()
    if K.cfconv_bwd_sym.launches != before + 1 or not all(
            t.grad is not None and torch.isfinite(t.grad).all()
            and t.grad.abs().sum() > 0 for t in ins):
        fail("cfconv_fused_sym under autograd on CUDA: no finite nonzero "
             "gradient through cfconv_bwd_sym")
    print("gradient flows through cfconv_fwd_sym: cfconv_bwd_sym launched, "
          "x and the filter weights get finite nonzero gradients")
    # the NCSN head's Function is first order only (so is the JAX
    # package's); the CFConv and PaiNN second orders are held in phase 3f
    ngrid, nweights, nanneal = ncsn_inputs(
        ddm0, pack_batch([sorted_store.get(int(i)) for i in first(32, 8)],
                         32).to(dev), targs, SEED)

    def ncsn_double_backward():
        u = ngrid[4].clone().requires_grad_(True)
        rows = NS.ncsn_score_loss(*ngrid[:4], u, *nweights, nanneal)
        (gu,) = torch.autograd.grad(rows.sum(), u, create_graph=True)
        gu.sum().backward()

    msg = refuses_grad(ncsn_double_backward)
    if msg is None:
        fail("a double backward through ncsn_score_loss on CUDA did not raise")
    print(f"grad guard ncsn_score_bwd (second order): {msg}")
    with torch.no_grad():
        stack_w = [t.clone().requires_grad_(True) for t in model.stacked_weights()]
    _, d128, e128, h128, _ = layer0_inputs(model, first(128, 2), 128)
    msg = refuses_grad(lambda: K.schnet_stack(
        d128.clone(), e128.clone(), h128.clone(), stack_w, 0.0, cutoff, G))
    if msg is None:
        fail("schnet_stack under autograd on CUDA did not raise")
    print(f"grad guard schnet_stack: {msg}")

    # -- 3b'. main path: PaiNN-DDM pretraining -----------------------------------------
    out_dir_p = os.path.join(ROOT, "runs", "chip_smoke_painn")
    shutil.rmtree(out_dir_p, ignore_errors=True)
    painn_argv = ["--model_3d", "painn"]
    reset_launch_counts()
    t0 = time.time()
    ddm_p, losses_p = PG.main(train_argv[:-1] + [out_dir_p] + painn_argv)
    torch.cuda.synchronize()
    train_launches_p = launch_counts()
    print(f"main path (PaiNN training): {len(losses_p)} steps of one epoch in "
          f"{time.time() - t0:.2f} s (first call); launches {train_launches_p}")
    for name in ("painn_fwd", "painn_bwd", "ncsn_score_fwd", "ncsn_score_bwd"):
        if train_launches_p[name] == 0:
            fail(f"kernel {name} was not launched on the PaiNN training path")
    if not losses_p or not all(math.isfinite(v) for v in losses_p):
        fail(f"PaiNN training losses {losses_p}")
    print(f"PaiNN training losses: {losses_p}")
    emb_tp = Predictor.from_checkpoint(
        os.path.join(out_dir_p, "model.pth"), cfg_p, batch_size=128,
        bucket_sizes=train_buckets).embed(train_store)
    if emb_tp.shape != (len(train_store), cfg_p.emb_dim) or \
            not np.isfinite(emb_tp).all():
        fail(f"PaiNN Predictor on model.pth: shape {emb_tp.shape} or non-finite")
    print(f"PaiNN model.pth loads into a Predictor: {emb_tp.shape[0]} finite "
          "embeddings")
    targs_p = PG.build_parser().parse_args(painn_argv)
    ddm0_p = PG.make_ddm(targs_p, common.model_config_from_args(targs_p),
                         torch.Generator().manual_seed(SEED)).to(dev)
    for b in train_buckets:
        step_parity(ddm0_p, train_batch(b), targs_p, b, "PaiNN")
    with torch.no_grad():
        stack_wp = [t.clone().requires_grad_(True)
                    for t in model_p.stacked_weights()]
    grids128, q128, _, _ = painn_inputs(model_p, packed(first(128, 2), 128))
    msg = refuses_grad(lambda: P.painn_stack_infer(
        *grids128, q128, stack_wp, cut_p))
    if msg is None:
        fail("painn_stack under autograd on CUDA did not raise")
    print(f"grad guard painn_stack: {msg}")

    # -- 3b''. main path: DDM-PaiNN through the differentiable whole stack -------
    # both views through models/painn.stack_train_apply (painn_stack_train:
    # the stack kernel saves the block boundaries, the backward runs
    # painn_bwd per block), one full-width step per bucket on the freshly
    # seeded DDM-PaiNN model, each held to the per-block kernel step
    from geossl_tpu_torch.models.painn import stack_train_apply

    draws_of = {b: step_draws(ddm0_p, train_batch(b), targs_p, b)
                for b in train_buckets}
    stack_grads = {}
    reset_launch_counts()
    t0 = time.time()
    for b in train_buckets:
        pos2, sel, draws = draws_of[b]
        stack_grads[b] = grads_in_chunks(
            ddm0_p, train_batch(b), lambda sb, sl: ddm_stack_loss(
                ddm0_p, sb, pos2[sl], sel[sl], tuple(t[sl] for t in draws)))
    torch.cuda.synchronize()
    stack_launches = launch_counts()
    print(f"main path (PaiNN training through the stack): one step per bucket "
          f"in {time.time() - t0:.2f} s (first call); launches "
          f"{stack_launches}")
    for name in ("painn_stack_train", "painn_bwd", "ncsn_score_fwd",
                 "ncsn_score_bwd"):
        if stack_launches[name] == 0:
            fail(f"kernel {name} was not launched on the stack training path")
    if stack_launches["painn_fwd"] != 0:
        fail("the stack training path ran the per-block forward")
    for b in train_buckets:
        pos2, sel, draws = draws_of[b]
        loss_k, grads_k = ddm_grads(ddm0_p, train_batch(b), pos2, sel, draws)
        check_step_parity(f"PaiNN stack step vs per-block step bucket {b}",
                          *stack_grads[b], loss_k, grads_k)
    print("painn_stack_train_instances: " + json.dumps(
        {f"B=128 N={b}": stack_ptxas(128, b, True) for b in train_buckets}))
    q_g = q128.clone().requires_grad_(True)

    def stack_double_backward():
        q, _ = P.painn_stack_train(*grids128, q_g, model_p.stacked_weights(),
                                   cut_p)
        torch.autograd.grad(q.square().sum(), q_g, create_graph=True)

    msg = refuses_grad(stack_double_backward)
    if msg is None:
        fail("a double backward through painn_stack_train on CUDA did not raise")
    print(f"grad guard painn_stack_train (second order): {msg}")

    # -- 3c. main path: the Atom3D fine-tunes at N=512 --------------------------
    pretrained = os.path.join(out_dir, "model.pth")  # DDM-SchNet, phase 3b
    lba_flags = ["--synthetic", "--synthetic_size", "160"]
    lep_flags = ["--synthetic", "--synthetic_size", "64"]

    def finetune_path(driver, task, flags, kernels, model_3d="schnet",
                      pre=pretrained):
        """driver.main from the pretrained model.pth (launch counts,
        finite losses and metrics), then its model.pth under --eval_only."""
        run_dir = os.path.join(ROOT, "runs", f"chip_smoke_{task}_{model_3d}")
        shutil.rmtree(run_dir, ignore_errors=True)
        reset_launch_counts()
        t0 = time.time()
        _, best, test, losses = driver.main(
            flags + ["--model_3d", model_3d, "--input_model_file", pre,
                     "--output_model_dir", run_dir])
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"main path ({task} fine-tune, {model_3d}): {len(losses)} steps "
              f"in {time.time() - t0:.2f} s (first call); launches {counts}")
        for name in kernels:
            if counts[name] == 0:
                fail(f"kernel {name} was not launched on the {task} path")
        if not losses or not all(math.isfinite(v) for v in losses) or \
                not math.isfinite(best) or \
                not all(math.isfinite(v) for v in test.values()):
            fail(f"{task} {model_3d}: losses {losses}, best val {best}, "
                 f"test {test}")
        print(f"{task} {model_3d} losses: {losses}; best val {best}; test at "
              f"best {test}")
        _, val_e, _, _ = driver.main(
            flags + ["--model_3d", model_3d, "--eval_only",
                     "--input_model_file", os.path.join(run_dir, "model.pth")])
        if not abs(val_e - best) <= RTOL * abs(best):
            fail(f"{task} {model_3d}: model.pth under --eval_only reads val "
                 f"{val_e}, the run's best was {best}")
        print(f"{task} {model_3d}: model.pth reloads under --eval_only (val "
              f"{val_e})")
        return counts

    lba_launches = finetune_path(FL, "lba", lba_flags + ["--epochs", "2"],
                                 ("cfconv_fwd_sym", "cfconv_bwd_sym"))
    finetune_path(FE, "lep", lep_flags + ["--epochs", "1"],
                  ("cfconv_fwd_sym", "cfconv_bwd_sym"))
    # PaiNN at N=512 from the DDM-PaiNN model.pth: its route there is the
    # symmetric pair
    lba_launches_p = finetune_path(FL, "lba", lba_flags + ["--epochs", "1"],
                                   ("painn_fwd_sym", "painn_bwd_sym"), "painn",
                                   os.path.join(out_dir_p, "model.pth"))

    # one full-width LBA-SchNet step at N=512 with kernels against the same
    # step with the plain versions (in graph chunks), on a freshly seeded net
    lba_args = FL.build_parser().parse_args(lba_flags)
    lba_batch = next(iter(BucketedLoader(FL.load_splits(lba_args)[0], 64,
                                         (512,), seed=SEED).epoch(1))).to(dev)
    net0 = FL.make_net(lba_args, common.model_config_from_args(lba_args),
                       torch.Generator().manual_seed(SEED)).to(dev)

    def lba_loss(sb, sl):
        return FL.loss_fn(net0, sb)

    loss_k, grads_k = grads_in_chunks(net0, lba_batch, lba_loss)
    net0.plain = True
    loss_p, grads_p = grads_in_chunks(net0, lba_batch, lba_loss, chunk=4)
    net0.plain = False
    check_step_parity("LBA-SchNet step parity bucket 512", loss_k, grads_k,
                      loss_p, grads_p)

    # PaiNN at the same batch (B=64, N=512), a shape the DDM path does not
    # give its kernels: painn_fwd/painn_bwd against their plain versions on
    # block 0's inputs, then one LBA-PaiNN step against the plain step, on a
    # freshly seeded net
    lba_args_p = FL.build_parser().parse_args(lba_flags + ["--model_3d",
                                                           "painn"])
    cfg_lp = common.model_config_from_args(lba_args_p)
    net0_p = FL.make_net(lba_args_p, cfg_lp,
                         torch.Generator().manual_seed(SEED)).to(dev)
    cut_lp = cfg_lp.painn.cutoff
    grids, q0, x, mu = painn_inputs(net0_p.model, lba_batch)
    with torch.no_grad():
        wk0, bk0 = net0_p.model.filter_weights()[0]
        want = chunked(lambda *a: torch.cat(P.painn_message_reference(
            *a, wk0, bk0, cut_lp), dim=-1), (*grids, x, mu), (), 4)
        for sp in (False, True):
            errs.check("painn_fwd", torch.cat(P.painn_message_fused(
                *grids, x, mu, wk0, bk0, cut_lp, sp), dim=-1), want,
                f"LBA B=64 N=512 sparse={sp}")
    gen_l = torch.Generator(dev).manual_seed(SEED)
    gq = torch.randn(q0.shape, generator=gen_l, device=dev)
    gmu = torch.randn(mu.shape, generator=gen_l, device=dev)
    want_bwd_l = check_painn_bwd(errs, grids, x, mu, wk0, bk0, gq, gmu,
                                 cut_lp, "LBA B=64 N=512", chunk=2)

    def lba_loss_p(sb, sl):
        return FL.loss_fn(net0_p, sb)

    loss_k, grads_k = grads_in_chunks(net0_p, lba_batch, lba_loss_p)
    net0_p.plain = True
    loss_p, grads_p = grads_in_chunks(net0_p, lba_batch, lba_loss_p, chunk=2)
    net0_p.plain = False
    check_step_parity("LBA-PaiNN step parity bucket 512", loss_k, grads_k,
                      loss_p, grads_p)

    # -- 3d. main path: the symmetric PaiNN pair at the LBA shape ----------------
    # PaiNN's route from N=256 (painn_message(symmetric=True) when the pair
    # grids are symmetric): block 0's inputs of the LBA-PaiNN batch (B=64,
    # N=512: symmetric dist/gate, antisymmetric directions, no
    # max_neighbors) through the dispatcher and the wrappers, then a
    # serving-like partial batch at N=256 (11 molecules in 128 graph slots)
    d_l, g_l = grids[0], grids[1]
    if not (torch.equal(d_l, d_l.transpose(1, 2))
            and torch.equal(g_l, g_l.transpose(1, 2))
            and all(torch.equal(t, -t.transpose(1, 2)) for t in grids[2:])):
        fail("the LBA-PaiNN pair grids are not (anti)symmetric")
    with torch.no_grad():
        got = torch.cat(P.painn_message(*grids, x, mu, wk0, bk0, cut_lp,
                                        symmetric=True), dim=-1)
        errs.check("painn_fwd_sym", got, want, "LBA B=64 N=512 dispatcher")
        errs.check("painn_fwd_sym", got, torch.cat(P.painn_message_fused(
            *grids, x, mu, wk0, bk0, cut_lp, True), dim=-1),
            "LBA B=64 N=512 against painn_fwd")
    check_painn_sym(errs, grids, x, mu, wk0, bk0, gq, gmu, cut_lp,
                    "LBA B=64 N=512", want, want_bwd_l)
    g256, q256, x256, mu256 = painn_inputs(model_p,
                                           packed(first(256, 11), 256, 128))
    if int((g256[1].flatten(1) != 0).any(1).sum()) != 11:
        fail("the N=256 partial batch does not hold 11 graphs in 128 slots")
    gen_s = torch.Generator(dev).manual_seed(SEED + 1)
    check_painn_sym(errs, g256, x256, mu256, wk_p, bk_p,
                    torch.randn(q256.shape, generator=gen_s, device=dev),
                    torch.randn(mu256.shape, generator=gen_s, device=dev),
                    cut_p, "serving partial B=128 (11 graphs) N=256")

    def pair_chain(op):
        """Gradients to positions, x, mu, Wk and bk of a scalar loss through
        pairwise_directions, the cosine-cutoff gate and ``op``."""
        pos = lba_batch.positions.clone().requires_grad_(True)
        ins = [t.clone().requires_grad_(True) for t in (x, mu, wk0, bk0)]
        dist, direction, pm = geometry.pairwise_directions(
            pos, lba_batch.node_mask)
        gate = cosine_cutoff(dist, cut_lp) * \
            geometry.radius_adjacency(dist, pm, cut_lp).float()
        dq, dmu = op(dist, gate, *(direction[..., c].contiguous()
                                   for c in range(3)), *ins, cut_lp)
        loss = torch.tanh(dq).sum() + torch.tanh(dmu).sum()
        return torch.autograd.grad(loss, [pos] + ins)

    reset_launch_counts()
    g_sym = pair_chain(lambda *a: P.painn_message(*a, symmetric=True))
    torch.cuda.synchronize()
    sym_launches = launch_counts()
    print(f"main path (symmetric PaiNN pair, LBA B=64 N=512, forward and "
          f"backward through the positions): launches {sym_launches}")
    for name in ("painn_fwd_sym", "painn_bwd_sym"):
        if sym_launches[name] == 0:
            fail(f"kernel {name} was not launched on the symmetric pair's path")
    g_ref = pair_chain(lambda *a: P.painn_message_fused(*a, True))
    for name, a, w in zip(("positions", "x", "mu", "Wk", "bk"), g_sym, g_ref):
        rel = rel_norm(a, w)
        if not torch.isfinite(a).all() or rel > 1e-5:
            fail(f"symmetric pair chain d{name}: relative norm {rel:.3e} "
                 "against the painn_fwd/painn_bwd chain (limit 1e-5)")
        print(f"symmetric pair chain d{name}: rel_norm {rel:.3e} against the "
              "painn_fwd/painn_bwd chain")
    fwd_args = (*grids, x, mu, wk0, bk0, cut_lp, True)
    bwd_args = (*grids, x, mu, wk0, bk0, gq, gmu, cut_lp, True)
    sym_ms = {"painn_fwd": cuda_time_ms(lambda: P.painn_message_fused(*fwd_args)),
              "painn_fwd_sym": cuda_time_ms(
                  lambda: P.painn_message_fused_sym(*fwd_args)),
              "painn_bwd": cuda_time_ms(lambda: P.painn_bwd(*bwd_args)),
              "painn_bwd_sym": cuda_time_ms(lambda: P.painn_bwd_sym(*bwd_args))}
    # the LBA-PaiNN step (forward and backward of the loss, every block)
    # through each route: device busy ms of one traced step, three steps
    # each, in turns; the plain route by lifting the symmetric pair's N
    params_p = [t for t in net0_p.parameters() if t.requires_grad]

    def lba_step_p():
        torch.autograd.grad(FL.loss_fn(net0_p, lba_batch), params_p)

    keep = P._SYM_MIN_N
    step_ms = {"symmetric": [], "plain": []}
    for _ in range(3):
        for route in ("symmetric", "plain"):
            P._SYM_MIN_N = keep if route == "symmetric" else 1 << 30
            lba_step_p()
            step_ms[route].append(device_profile(lba_step_p)[1] * 1e3)
    P._SYM_MIN_N = keep
    routed = "symmetric" if P.sym_profitable(lba_batch.positions.shape[1]) \
        else "plain"
    print("painn_sym_vs_plain_kernels: " + json.dumps(
        {"shape": "LBA B=64 N=512", "ms": sym_ms,
         "lba_painn_step_device_ms": {k: sorted(v)[1]
                                      for k, v in step_ms.items()},
         "lba_painn_step_device_ms_runs": step_ms, "routed": routed}))
    sym_case = (grids, x, mu, wk0, bk0, gq, gmu)

    # -- 3e. main path: the QM9 fine-tune at bucket 32 ---------------------------
    # each kernel's launches over both backbones' epochs (the kernel
    # table's qm9_launches)
    qm9_launches = {}
    for model_3d, pre, path_kernels, stack_kernel in (
            ("schnet", pretrained, ("cfconv_fwd_sym", "cfconv_bwd_sym"),
             "schnet_stack"),
            ("painn", os.path.join(out_dir_p, "model.pth"),
             ("painn_fwd", "painn_bwd"), "painn_stack")):
        for name, n in qm9_path(dev, model_3d, pre, path_kernels,
                                stack_kernel).items():
            qm9_launches[name] = qm9_launches.get(name, 0) + n

    # -- 3f. main path: the MD17 energy+force fine-tune at bucket 32 ------------
    # each kernel's launches per training step (the kernel table's
    # md17_launches), then the four second orders at the MD17 shape
    md17_launches, md17_nets = {}, {}
    for model_3d, pre, path_kernels in (
            ("schnet", pretrained, ("cfconv_fwd_sym", "cfconv_bwd_sym")),
            ("painn", os.path.join(out_dir_p, "model.pth"),
             ("painn_fwd", "painn_bwd"))):
        step_counts, md17_nets[model_3d], md17_batch = md17_path(
            dev, model_3d, pre, path_kernels)
        md17_launches.update(step_counts)
    check_second_orders(md17_batch, md17_nets["schnet"], md17_nets["painn"])

    # -- 3g. main path: the pretraining objectives beyond DDM -----------------
    # per backbone: InfoNCE, EBM_NCE, RR and the six baselines, each step at
    # bucket 128 held to its plain step, contextpred's holed node masks at
    # the kernel level, each driver's epoch (the kernel table's
    # pretrain_launches: each kernel's launches per step)
    pretrain_launches, baseline_graph_launches = pretrain_path(
        errs, dev, card, train_batch)

    # -- 3h. main path: the rest of serving -----------------------------------
    # LEP pairs from phase 3c's LEP-SchNet model.pth (PaiNN: the DDM-PaiNN
    # backbone with a seeded dual head), sealed artifacts of phase 3e's
    # QM9 model.pth per backbone and of the LEP checkpoints, .sdf input,
    # the custom ops' host cost (the kernel table's pairs_launches and
    # sealed_launches)
    lep_painn = os.path.join(ROOT, "runs", "chip_smoke_lep_painn.pth")
    torch.save({
        "model": torch.load(os.path.join(out_dir_p, "model.pth"),
                            weights_only=True)["model"],
        "graph_pred_linear": common.DualHead(
            cfg_p.emb_dim, torch.Generator().manual_seed(SEED)).state_dict()},
        lep_painn)
    pairs_launches, sealed_launches = serving_rest_path(
        dev, card,
        {m: os.path.join(ROOT, "runs", f"chip_smoke_qm9_{m}", "model.pth")
         for m in ("schnet", "painn")},
        {"schnet": os.path.join(ROOT, "runs", "chip_smoke_lep_schnet",
                                "model.pth"), "painn": lep_painn},
        store)

    # -- 3i. the host runtime -------------------------------------------------------
    # the C++ packer against the NumPy pack (packer:), graph-replayed steps
    # against eager steps (graph_parity:), one pretrain_geossl
    # --profile_dir epoch (profile_dir:), and the drivers' loops in three
    # modes (host_runtime:)
    packer_check(card)
    graph_parity_path(dev)
    profile_dir_check(dev)
    host_runtime_path(dev, card)

    # -- 3j. parallel: gloo ranks sharing the card, pair stripes, NCCL graphs
    pair_launches, stripe_rows = parallel_path(
        dev, card, errs, lba_batch, {"schnet": net0, "painn": net0_p}, G,
        cutoff, cut_lp)

    # -- 3k. tools: doctor, the Molecule3D build, evalkit, flops, se3_basis
    tools_path(dev, card, pretrained, train_batch(128))

    # -- 4. measurements -----------------------------------------------------------
    subs = {b: MolStore.from_records([sorted_store.get(int(i))
                                      for i in np.nonzero(bucket_of == b)[0]])
            for b in buckets}
    measure_serving(pred, subs, "schnet")
    measure_serving(pred_p, subs, "painn")
    route_batches = {b: packed(first(b, 128), b, 128) for b in (32, 64, 128)}
    measure_serving_route(pred, route_batches, "schnet", "schnet_stack")
    measure_serving_route(pred_p, route_batches, "painn", "painn_stack")

    flop_pair = 2 * G * 128 + 2 * 128 * 128 + 2 * 128
    kernels = []
    stack_shape = {}  # stack kernel -> (B, N, residual mode) of its row
    with torch.inference_mode():
        def serving_batch(m, b):
            """The bucket's first batch as the Predictor packs it."""
            return layer0_inputs(m, first(b, 128), b, batch_size=128)

        # schnet_stack at the N=128 bucket's first batch, padded to 128
        # slots, in the symmetric mode serving takes (held above); the plain
        # mode's time on the max_neighbors=32 graph beside it
        batch, dist, env, h0, _ = serving_batch(model, 128)
        L = stacked[0].shape[0]
        ms = cuda_time_ms(lambda: K.schnet_stack(dist, env, h0, stacked, 0.0,
                                                 cutoff, G, True))
        plain_ms = cuda_time_ms(lambda: chunked(
            K.schnet_stack_reference, (dist, env, h0), (stacked, 0.0, cutoff, G),
            32), reps=3, warmup=1)
        _, d_mn, e_mn, h_mn, _ = serving_batch(model_mn, 128)
        print("schnet_stack_modes: " + json.dumps({
            "shape": "serving B=128 N=128", "ms": {
                "symmetric": ms, "plain_max_neighbors_32": cuda_time_ms(
                    lambda: K.schnet_stack(d_mn, e_mn, h_mn, stacked, 0.0,
                                           cutoff, G, False))}}))
        nnz, filt_pairs, cells, tiles = pair_work(dist, env)
        if cells == dist.numel():
            fail("schnet_stack: serving dist/env are not symmetric")
        atoms = int(batch.node_mask.sum())
        # tensor cores: the filter network once per needed pair and the
        # three dense layers per atom; CUDA cores: the messages per pair
        flops = (L * (filt_pairs * (flop_pair - 2 * 128)
                      + atoms * 3 * 2 * 128 * 128), L * nnz * 2 * 128)
        nbytes = 4 * (cells + tiles + 2 * h0.numel()
                      + sum(t.numel() for t in stacked))
        kernels.append(("schnet_stack", "geossl_tpu_torch/ops/csrc/schnet_stack.cu",
                        "geossl_tpu/ops/cfconv_pallas.py:712", ms, plain_ms,
                        flops, nbytes))

        for name, m, fw, fn, b, sym in (
                ("cfconv_fwd", model_mn, filt_mn, K.cfconv_fused, 256, False),
                ("cfconv_fwd_sym", model, filt, K.cfconv_fused_sym, 512, True)):
            batch, dist, env, _, x = serving_batch(m, b)
            want = chunked(K.cfconv_fused_reference, (dist, env, x),
                           (*fw, 0.0, cutoff, G), 4)
            for sp in (False, True):
                got = fn(dist, env, x, *fw, 0.0, cutoff, G, sp)
                errs.check(name, got, want,
                           f"serving B={dist.shape[0]} N={b} sparse={sp}")
                # the plain mode writes each row once: two launches agree
                # bitwise
                if not sym and not torch.equal(got, fn(dist, env, x, *fw, 0.0,
                                                       cutoff, G, sp)):
                    fail(f"{name} serving N={b} sparse={sp}: outputs differ "
                         "between two launches")
            ms = cuda_time_ms(lambda: fn(dist, env, x, *fw, 0.0, cutoff, G, True))
            plain_ms = cuda_time_ms(lambda: chunked(
                K.cfconv_fused_reference, (dist, env, x), (*fw, 0.0, cutoff, G),
                4), reps=3, warmup=1)
            nnz, filt_pairs, cells, tiles = pair_work(dist, env)
            if sym and cells == dist.numel():
                fail(f"{name}: serving dist/env are not symmetric")
            # both modes run the filter's two products on the tensor cores,
            # the messages on the CUDA cores
            flops = (filt_pairs * (flop_pair - 2 * 128), nnz * 2 * 128)
            nbytes = 4 * (cells + tiles + 2 * x.numel()
                          + sum(t.numel() for t in fw))
            kernels.append((name, "geossl_tpu_torch/ops/csrc/cfconv_fwd.cu",
                            "geossl_tpu/ops/cfconv_pallas.py:382" if sym
                            else "geossl_tpu/ops/cfconv_pallas.py:92",
                            ms, plain_ms, flops, nbytes))

    kernels = [(*k, launches[k[0]]) for k in kernels]

    tbatches = [train_batch(b) for b in train_buckets]
    measure_training(ddm, targs, tbatches, "schnet")
    measure_training(ddm_p, targs_p, tbatches, "painn")
    measure_stack_training(ddm0_p, targs_p, tbatches)
    measure_finetune(net0, lba_args, lba_batch, FL.loss_fn, "lba",
                     int(lba_batch.graph_mask.sum()))
    measure_finetune(net0_p, lba_args_p, lba_batch, FL.loss_fn, "lba",
                     int(lba_batch.graph_mask.sum()))
    lep_args = FE.build_parser().parse_args(lep_flags)
    lep_batch = next(iter(FE.DualLoader(
        *FE.load_splits(lep_args)["train"], 16, (512,), shuffle=True,
        seed=SEED).epoch(1))).to(dev)
    lep_net = FE.make_net(lep_args, common.model_config_from_args(lep_args),
                          torch.Generator().manual_seed(SEED)).to(dev)
    measure_finetune(lep_net, lep_args, lep_batch, FE.loss_fn, "lep",
                     int(lep_batch.active.graph_mask.sum()))

    def ddm_case(b, ddm=ddm0):
        """Block 0's CFConv inputs on the DDM batch of bucket b (B=128, the
        clean graph of view 1, a freshly seeded DDM model: ``ddm0``'s graph
        is symmetric, ``ddm0_mn``'s truncated to 32 neighbours) and a seeded
        cotangent."""
        batch = train_batch(b)
        with torch.no_grad():
            dist, adj = ddm.model.geometry(batch.positions, batch.node_mask)
            dist = dist.contiguous()
            env = ddm.model.envelope(dist, adj).contiguous()
            blk = ddm.model.interactions[0]
            x = blk.conv.lin1(ddm.model.embedding(batch.atom_type)).contiguous()
            fw = blk.filter_weights()
        g = torch.randn(x.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
        return dist, env, x, g, fw

    # the three training kernels at the DDM shape (B=128, N=128): the
    # plain-mode CFConv backward on the graph of its path, the clean graph
    # truncated to 32 neighbours (the max_num_neighbors run launches it)
    batch = train_batch(128)
    F_, E_, H_ = 128, 128, 64
    dist, env, x, g, fw = ddm_case(128, ddm0_mn)
    if torch.equal(env, env.transpose(1, 2)):
        fail("cfconv_bwd: the max_neighbors=32 graph came out symmetric")
    check_cfconv_bwd(errs, dist, env, x, g, fw, G, cutoff,
                     "DDM max_neighbors=32 B=128 N=128", chunk=4)
    ms = cuda_time_ms(lambda: K.cfconv_bwd(dist, env, x, g, *fw, 0.0, cutoff,
                                           G, True))
    plain_ms = cuda_time_ms(lambda: chunked_sum(
        K.cfconv_bwd_reference, (dist, env, x, g), (*fw, 0.0, cutoff, G), 4, 3),
        reps=3, warmup=1)
    nnz, filt_pairs, cells, tiles = pair_work(dist, env)
    # tensor-core products: the filter once per needed pair, dW2 and dh
    # (2F^2 each), dW1 and drbf (2GF each) per ordered pair; on the CUDA
    # cores the elementwise qe/denv/dx terms per ordered pair
    flops = (filt_pairs * (2 * G * F_ + 2 * F_ * F_)
             + nnz * (4 * F_ * F_ + 4 * G * F_), nnz * 6 * F_)
    wsize = G * F_ + 2 * F_ + F_ * F_
    nbytes = 4 * (cells + tiles + 2 * dist.numel() + 3 * x.numel() + 2 * wsize)
    kernels.append(("cfconv_bwd", "geossl_tpu_torch/ops/csrc/cfconv_bwd.cu",
                    "geossl_tpu/ops/cfconv_pallas.py:150", ms, plain_ms, flops,
                    nbytes, mn_launches["cfconv_bwd"]))
    # the plain-mode forward on the same graph (its training path: the
    # max_num_neighbors run above launches it), held to its plain version,
    # two launches bitwise equal, its time, bound and launches
    with torch.no_grad():
        got = K.cfconv_fused(dist, env, x, *fw, 0.0, cutoff, G, True)
        errs.check("cfconv_fwd", got, chunked(
            K.cfconv_fused_reference, (dist, env, x), (*fw, 0.0, cutoff, G), 4),
            "DDM max_neighbors=32 B=128 N=128 sparse=True")
        if not torch.equal(got, K.cfconv_fused(dist, env, x, *fw, 0.0, cutoff,
                                                G, True)):
            fail("cfconv_fwd DDM max_neighbors=32: outputs differ between two "
                 "launches")
        t_ops = filt_pairs * (flop_pair - 2 * 128)
        e_ops = nnz * 2 * 128
        nbytes = 4 * (cells + tiles + 2 * x.numel() + sum(t.numel() for t in fw))
        print("cfconv_fwd_ddm: " + json.dumps({
            "shape": "DDM max_neighbors=32 B=128 N=128",
            "ms": cuda_time_ms(lambda: K.cfconv_fused(dist, env, x, *fw, 0.0,
                                                      cutoff, G, True)),
            "plain_ms": cuda_time_ms(lambda: chunked(
                K.cfconv_fused_reference, (dist, env, x), (*fw, 0.0, cutoff, G),
                4), reps=3, warmup=1),
            "bound_ms": max(t_ops / PEAK_TF32_FLOPS, e_ops / PEAK_F32_FLOPS,
                            nbytes / PEAK_BYTES) * 1e3,
            "bound_ms_f32": max((t_ops + e_ops) / PEAK_F32_FLOPS,
                                nbytes / PEAK_BYTES) * 1e3,
            "launches": mn_launches["cfconv_fwd"]}))

    # the symmetric backward at the LBA shape (B=64, N=512, block 0 of a
    # freshly seeded net)
    with torch.no_grad():
        m = net0.model
        dist, adj = m.geometry(lba_batch.positions, lba_batch.node_mask)
        dist = dist.contiguous()
        env = m.envelope(dist, adj).contiguous()
        blk = m.interactions[0]
        x = blk.conv.lin1(m.embedding(lba_batch.atom_type)).contiguous()
        fw = blk.filter_weights()
    g = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(SEED),
                    device=dev)
    check_cfconv_bwd_sym(errs, dist, env, x, g, fw, G, cutoff,
                         "LBA B=64 N=512", chunk=4)
    ms = cuda_time_ms(lambda: K.cfconv_bwd_sym(dist, env, x, g, *fw, 0.0,
                                               cutoff, G, True))
    plain_ms = cuda_time_ms(lambda: chunked_sum(
        K.cfconv_bwd_sym_reference, (dist, env, x, g), (*fw, 0.0, cutoff, G),
        4, 3), reps=3, warmup=1)
    # the kernel header's claim: all but dx (atomics) repeat bitwise
    again = [K.cfconv_bwd_sym(dist, env, x, g, *fw, 0.0, cutoff, G, True)
             for _ in range(2)]
    print("cfconv_bwd_sym repeats bitwise: " + json.dumps(
        {n: torch.equal(a, b) for n, a, b in zip(BWD_NAMES, *again)}))
    nnz, filt_pairs, cells, tiles = pair_work(dist, env)
    if cells == dist.numel():
        fail("cfconv_bwd_sym: the LBA dist/env are not symmetric")
    # per pair with env != 0 counted once (one triangle): the filter, dW2,
    # dh, dW1 and drbf on the combined cotangent (tensor cores); per ordered
    # pair the elementwise q/denv/dx terms
    flops = (filt_pairs * (6 * G * F_ + 6 * F_ * F_), nnz * 6 * F_)
    nbytes = 4 * (cells + tiles + 2 * dist.numel() + 3 * x.numel() + 2 * wsize)
    kernels.append(("cfconv_bwd_sym", "geossl_tpu_torch/ops/csrc/cfconv_bwd.cu",
                    "geossl_tpu/ops/cfconv_pallas.py:464", ms, plain_ms, flops,
                    nbytes, lba_launches["cfconv_bwd_sym"]))

    def routed(d_, e_, x_, fw_):
        """The pair SchNet's dispatcher picks for symmetric dist/env."""
        reset_launch_counts()
        with torch.no_grad():
            K.cfconv(d_, e_, x_, *fw_, 0.0, cutoff, G, symmetric=True)
        return "symmetric" if launch_counts()["cfconv_fwd_sym"] else "plain"

    # the symmetric pair against the plain pair, forward and backward, at the
    # DDM buckets (B=128) and the LBA shape (B=64, N=512): the measurement
    # that SchNet's route (symmetric at every N) follows. On the DDM inputs,
    # the path the symmetric pair trains on, both symmetric kernels are held
    # to their plain versions first (the LBA inputs are held above)
    lba_case = (dist, env, x, g, fw)
    sym_vs = {}
    for n in (*train_buckets, 512):
        d_, e_, x_, g_, fw_ = lba_case if n == 512 else ddm_case(n)
        a_ = (*fw_, 0.0, cutoff, G, True)
        if n in train_buckets:
            what = f"DDM B={d_.shape[0]} N={n}"
            with torch.no_grad():
                want = chunked(K.cfconv_fused_reference, (d_, e_, x_),
                               (*fw_, 0.0, cutoff, G), 16)
                for sp in (False, True):
                    errs.check("cfconv_fwd_sym", K.cfconv_fused_sym(
                        d_, e_, x_, *fw_, 0.0, cutoff, G, sp), want,
                        f"{what} sparse={sp}")
            check_cfconv_bwd_sym(errs, d_, e_, x_, g_, fw_, G, cutoff, what,
                                 chunk=16)
        with torch.no_grad():
            r = {"cfconv_fwd": cuda_time_ms(lambda: K.cfconv_fused(d_, e_, x_, *a_)),
                 "cfconv_fwd_sym": cuda_time_ms(
                     lambda: K.cfconv_fused_sym(d_, e_, x_, *a_))}
        r["cfconv_bwd"] = cuda_time_ms(lambda: K.cfconv_bwd(d_, e_, x_, g_, *a_))
        r["cfconv_bwd_sym"] = cuda_time_ms(
            lambda: K.cfconv_bwd_sym(d_, e_, x_, g_, *a_))
        plain_pair = r["cfconv_fwd"] + r["cfconv_bwd"]
        sym_pair = r["cfconv_fwd_sym"] + r["cfconv_bwd_sym"]
        sym_vs[f"{'LBA' if n == 512 else 'DDM'} B={d_.shape[0]} N={n}"] = {
            "ms": r, "plain_pair_ms": plain_pair, "sym_pair_ms": sym_pair,
            "faster": "symmetric" if sym_pair < plain_pair else "plain",
            "routed": routed(d_, e_, x_, fw_)}
    print("cfconv_sym_vs_plain_kernels: " + json.dumps(sym_vs))
    # cfconv_fwd_sym on its training path (DDM B=128, N=128, the launches
    # of the DDM-SchNet epoch), beside its serving row in the kernel table
    d_, e_, x_, _, fw_ = ddm_case(128)
    nnz, filt_pairs, cells, tiles = pair_work(d_, e_)
    with torch.no_grad():
        print("cfconv_fwd_sym_ddm: " + json.dumps({
            "shape": "DDM B=128 N=128",
            "ms": sym_vs["DDM B=128 N=128"]["ms"]["cfconv_fwd_sym"],
            "plain_ms": cuda_time_ms(lambda: chunked(
                K.cfconv_fused_reference, (d_, e_, x_), (*fw_, 0.0, cutoff, G),
                16), reps=3, warmup=1),
            # the filter's products at the TF32 tensor-core peak, the
            # messages at the f32 peak, the bytes at the HBM rate
            "bound_ms": max(filt_pairs * (flop_pair - 2 * 128) / PEAK_TF32_FLOPS,
                            nnz * 2 * 128 / PEAK_F32_FLOPS,
                            4 * (cells + tiles + 2 * x_.numel()
                                 + sum(t.numel() for t in fw_))
                            / PEAK_BYTES) * 1e3,
            "bound_basis": "tf32_tensor_core+f32",
            "launches": train_launches["cfconv_fwd_sym"]}))

    grid, weights, anneal = ncsn_inputs(ddm0, batch, targs, SEED)
    g_rows = check_ncsn(errs, grid, weights, anneal, "DDM B=128 N=128", chunk=16)
    # no atomics: every output of the backward repeats bitwise
    again = [NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal)
             for _ in range(2)]
    same = [torch.equal(a, b) for a, b in zip(*again)]
    print(f"ncsn_score_bwd repeats bitwise: {all(same)}")
    if not all(same):
        fail(f"ncsn_score_bwd: outputs differ between two launches {same}")
    # both kernels' work lists on a partial batch: 5 real graphs in the 128
    # slots
    b5 = pack_batch([train_store.get(int(i))
                     for i in np.nonzero(tbucket == 128)[0][:5]], 128, 128).to(dev)
    grid5, weights5, anneal5 = ncsn_inputs(ddm0, b5, targs, SEED)
    check_ncsn(errs, grid5, weights5, anneal5, "DDM partial B=128 (5 graphs) N=128",
               chunk=16)
    # no atomics in the forward either: its rows repeat bitwise
    for what, (g_, w_, a_) in (("DDM B=128 N=128", (grid, weights, anneal)),
                               ("DDM partial B=128 (5 graphs) N=128",
                                (grid5, weights5, anneal5))):
        rows = [NS.ncsn_score_fwd(*g_, *w_, anneal=a_) for _ in range(2)]
        print(f"ncsn_score_fwd {what} repeats bitwise: {torch.equal(*rows)}")
        if not torch.equal(*rows):
            fail(f"ncsn_score_fwd {what}: rows differ between two launches")
    sel_pairs = int((grid[2] != 0).sum())
    bsz, n = grid[0].shape[:2]
    head_w = sum(w.numel() for w in weights)
    fwd_pair = 2 * E_ * H_ + 8 * E_ + 2 * H_ + 10
    for name, fn, plain, flops, nbytes, line in (
            # tensor cores: l1 W2; CUDA cores: the distance MLP, l1, the
            # relu, w3, the score and the loss
            ("ncsn_score_fwd",
             lambda: NS.ncsn_score_fwd(*grid, *weights, anneal=anneal),
             lambda: chunked(NS.ncsn_score_loss_reference, grid,
                             (*weights, anneal), 16),
             (sel_pairs * 2 * E_ * H_, sel_pairs * (fwd_pair - 2 * E_ * H_)),
             4 * (3 * grid[0].numel() + grid[4].numel() + bsz + head_w
                  + bsz * n), 67),
            # tensor cores: l1 W2 recomputed, dl1 = dx2 W2^T, dW2 += l1^T
            # dx2; CUDA cores: the elementwise chain of both directions
            ("ncsn_score_bwd",
             lambda: NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal),
             lambda: chunked_sum(
                 lambda *a: NS.ncsn_score_bwd_reference(*a, anneal=anneal),
                 (*grid, g_rows), weights, 16, 1),
             (sel_pairs * 6 * E_ * H_,
              sel_pairs * (fwd_pair - 2 * E_ * H_ + 12 * E_ + 4 * H_)),
             4 * (3 * grid[0].numel() + 2 * grid[4].numel() + bsz
                  + bsz * n + 2 * head_w), 135)):
        # launched by both DDM epochs' heads (SchNet and PaiNN)
        kernels.append((name, "geossl_tpu_torch/ops/csrc/ncsn_score.cu",
                        f"geossl_tpu/ops/ncsn_pallas.py:{line}",
                        cuda_time_ms(fn), cuda_time_ms(plain, reps=3, warmup=1),
                        flops, nbytes,
                        train_launches[name] + train_launches_p[name]))

    # PaiNN: the stack at serving's first batch of buckets 32, 64 and 128
    # (128 slots) whatever the route, and on a partial batch (5 graphs in 128
    # slots); the kernel table's row at N=32. The message pass and its
    # backward at the DDM shape (B=128 of the N=128 bucket, the clean graph
    # of view 1)
    R_, L_ = cfg_p.painn.n_rbf, cfg_p.painn.n_interactions

    def bounds(ops, nbytes_):
        """(tensor-core basis, f32 basis) bound in ms."""
        t_ops, e_ops = ops
        return (max(t_ops / PEAK_TF32_FLOPS, e_ops / PEAK_F32_FLOPS,
                    nbytes_ / PEAK_BYTES) * 1e3,
                max((t_ops + e_ops) / PEAK_F32_FLOPS, nbytes_ / PEAK_BYTES) * 1e3)

    stack_shapes = {}
    with torch.inference_mode():
        for what, idx, nb in (
                ("serving B=128 N=32", first(32, 128), 32),
                ("serving B=128 N=64", first(64, 128), 64),
                ("serving B=128 N=128", first(128, 128), 128),
                ("partial B=128 (5 graphs) N=128", first(128, 5), 128)):
            batch = packed(idx, nb, 128)
            grids, q0, _, _ = painn_inputs(model_p, batch)
            got = P.painn_stack_infer(*grids, q0, stacked_p, cut_p)
            want = chunked_sum(lambda *a: P.painn_stack_reference(
                *a, stacked_p, cut_p), (*grids, q0), (), 32, 2)
            for name, a, w in zip(("q", "mu"), got, want):
                errs.check_scaled("painn_stack", a, w, f"{what} {name}")
            # no atomics: two launches agree bitwise
            if not all(torch.equal(a, b_) for a, b_ in zip(
                    got, P.painn_stack_infer(*grids, q0, stacked_p, cut_p))):
                fail(f"painn_stack {what}: outputs differ between two launches")
            ops, nbytes = painn_work("painn_stack", grids, q0, F_, R_, L_,
                                     stacked_p, int(batch.node_mask.sum()))
            bound_tc, bound_f32 = bounds(ops, nbytes)
            stack_shapes[what] = {
                "ms": cuda_time_ms(lambda: P.painn_stack_infer(
                    *grids, q0, stacked_p, cut_p)),
                "bound_ms": bound_tc, "bound_ms_f32": bound_f32,
                **stack_ptxas(q0.shape[0], nb, False)}
            if nb == 32 and "partial" not in what:
                row = (grids, q0, ops, nbytes, stack_shapes[what]["ms"])
        print("painn_stack repeats bitwise at every shape above")
        print("painn_stack_shapes: " + json.dumps(stack_shapes))
        grids, q0, ops, nbytes, ms = row
        plain_ms = cuda_time_ms(lambda: chunked_sum(
            lambda *a: P.painn_stack_reference(*a, stacked_p, cut_p),
            (*grids, q0), (), 32, 2), reps=3, warmup=1)
        stack_shape["painn_stack"] = (q0.shape[0], q0.shape[1], False)
        kernels.append(("painn_stack", "geossl_tpu_torch/ops/csrc/painn_stack.cu",
                        "geossl_tpu/ops/painn_pallas.py:829", ms, plain_ms,
                        ops, nbytes, launches_p["painn_stack"]))

    batch = train_batch(128)
    m0 = ddm0_p.model
    with torch.no_grad():
        d1, pm = geometry.pairwise_distances(batch.positions, batch.node_mask)
        clean = geometry.radius_adjacency(d1, pm, cut_p)
        wk0, bk0 = m0.filter_weights()[0]
    grids, q0, x, mu = painn_inputs(m0, batch, pair_mask=clean)
    gen_d = torch.Generator(dev).manual_seed(SEED)
    gq = torch.randn(q0.shape, generator=gen_d, device=dev)
    gmu = torch.randn(mu.shape, generator=gen_d, device=dev)
    check_painn_bwd(errs, grids, x, mu, wk0, bk0, gq, gmu, cut_p,
                    "DDM B=128 N=128", chunk=8)
    # no atomics in the plain mode: every output repeats bitwise
    again = [P.painn_bwd(*grids, x, mu, wk0, bk0, gq, gmu, cut_p, True)
             for _ in range(2)]
    same = {n: torch.equal(a, b) for n, a, b in zip(PAINN_BWD_NAMES, *again)}
    print("painn_bwd repeats bitwise: " + json.dumps(same))
    if not all(same.values()):
        fail(f"painn_bwd: outputs differ between two launches {same}")
    # a partial batch: 5 real graphs in the 128 slots
    idx5 = np.nonzero(tbucket == 128)[0][:5]
    b5 = pack_batch([train_store.get(int(i)) for i in idx5], 128, 128).to(dev)
    with torch.no_grad():
        d5, pm5 = geometry.pairwise_distances(b5.positions, b5.node_mask)
        clean5 = geometry.radius_adjacency(d5, pm5, cut_p)
    grids5, q5, x5, mu5 = painn_inputs(m0, b5, pair_mask=clean5)
    check_painn_bwd(errs, grids5, x5, mu5, wk0, bk0,
                    torch.randn(q5.shape, generator=gen_d, device=dev),
                    torch.randn(mu5.shape, generator=gen_d, device=dev), cut_p,
                    "DDM partial B=128 (5 graphs) N=128", chunk=8)

    # painn_fwd at every shape its paths give it: the DDM batches (B=128,
    # the clean graph, gating as the dispatcher sets it: off at N=32/64, on
    # at N=128) and the partial one, serving's first batch at N=128 and
    # N=512, and an uneven one (60 graphs of bucket 32 and 8 of bucket 128
    # at N=128): elementwise against the plain version, a second launch
    # bitwise equal to the first (no atomics), its time and its bound; the
    # LBA batch (B=64, N=512) was held in phase 3c and timed on the
    # painn_sym_vs_plain_kernels line
    fcases = []
    with torch.no_grad():
        for b in train_buckets:
            bt = train_batch(b)
            d_, pm_ = geometry.pairwise_distances(bt.positions, bt.node_mask)
            g_, _, x_, mu_ = painn_inputs(
                m0, bt, pair_mask=geometry.radius_adjacency(d_, pm_, cut_p))
            fcases.append((f"DDM B=128 N={b}", g_, x_, mu_, wk0, bk0))
    fcases.append(("DDM partial B=128 (5 graphs) N=128", grids5, x5, mu5, wk0,
                   bk0))
    for what, idx, b in (("serving B=128 N=128", first(128, 128), 128),
                         ("serving B=128 N=512", first(512, 128), 512),
                         ("uneven B=128 (60 + 8 graphs) N=128",
                          np.concatenate([first(32, 60), first(128, 8)]), 128)):
        g_, _, x_, mu_ = painn_inputs(model_p, packed(idx, b, 128))
        fcases.append((what, g_, x_, mu_, wk_p, bk_p))
    fwd_shapes = {}
    with torch.no_grad():
        for what, g_, x_, mu_, w_, b_ in fcases:
            sp = K.sparse_auto(g_[0].shape[-1], "auto")
            args_ = (*g_, x_, mu_, w_, b_, cut_p, sp)
            got = torch.cat(P.painn_message_fused(*args_), dim=-1)
            errs.check("painn_fwd", got, chunked(
                lambda *a: torch.cat(P.painn_message_reference(
                    *a, w_, b_, cut_p), dim=-1), (*g_, x_, mu_), (),
                16 if g_[0].shape[-1] <= 128 else 4), f"{what} sparse={sp}")
            if not torch.equal(got, torch.cat(P.painn_message_fused(*args_),
                                              dim=-1)):
                fail(f"painn_fwd {what}: outputs differ between two launches")
            (t_ops, e_ops), nbytes = painn_work("painn_fwd", g_, x_, F_, R_)
            fwd_shapes[what] = {
                "ms": cuda_time_ms(lambda: P.painn_message_fused(*args_)),
                "bound_ms": max(t_ops / PEAK_TF32_FLOPS, e_ops / PEAK_F32_FLOPS,
                                nbytes / PEAK_BYTES) * 1e3,
                "sparse": sp}
        (t_ops, e_ops), nbytes = painn_work("painn_fwd", sym_case[0],
                                            sym_case[1], F_, R_)
        fwd_shapes["LBA B=64 N=512"] = {
            "ms": sym_ms["painn_fwd"],
            "bound_ms": max(t_ops / PEAK_TF32_FLOPS, e_ops / PEAK_F32_FLOPS,
                            nbytes / PEAK_BYTES) * 1e3, "sparse": True}
    print("painn_fwd repeats bitwise at every shape above")
    print("painn_fwd_shapes: " + json.dumps(fwd_shapes))

    with torch.no_grad():
        fwd_args = (*grids, x, mu, wk0, bk0, cut_p, True)
        for name, fn, plain, flops, nbytes, line in (
                # tensor cores: the filter; CUDA cores: gating, the messages
                ("painn_fwd", lambda: P.painn_message_fused(*fwd_args),
                 lambda: chunked(lambda *a: torch.cat(
                     P.painn_message_reference(*a, wk0, bk0, cut_p), dim=-1),
                     (*grids, x, mu), (), 16),
                 *painn_work("painn_fwd", grids, x, F_, R_), 86),
                ("painn_bwd",
                 lambda: P.painn_bwd(*grids, x, mu, wk0, bk0, gq, gmu, cut_p,
                                     True),
                 lambda: chunked_sum(
                     lambda d, g, a, b_, c, xx, m, gq_, gmu_:
                     P.painn_bwd_reference(d, g, a, b_, c, xx, m, wk0, bk0,
                                           gq_, gmu_, cut_p),
                     (*grids, x, mu, gq, gmu), (), 8, 7),
                 *painn_work("painn_bwd", grids, x, F_, R_), 164)):
            kernels.append((name, f"geossl_tpu_torch/ops/csrc/{name}.cu",
                            f"geossl_tpu/ops/painn_pallas.py:{line}",
                            cuda_time_ms(fn), cuda_time_ms(plain, reps=3,
                                                           warmup=1),
                            flops, nbytes, train_launches_p[name]))

        # the differentiable stack's forward (save_residuals) on the same
        # batch: view 1 of the DDM step at N=128, the clean graph
        stacked0 = m0.stacked_weights()
        got = P._launch_painn_stack("painn_stack_train", grids, q0, stacked0,
                                    cut_p, m0.epsilon, True)
        want = chunked_sum(lambda *a: P.painn_stack_reference(
            *a, stacked0, cut_p, save_residuals=True), (*grids, q0), (), 32, 6)
        for name, a, w in zip(("q", "mu", "qs", "mus", "qps", "mups"), got,
                              want):
            errs.check_scaled("painn_stack_train", a, w,
                              f"DDM B=128 N=128 {name}")
        if not all(torch.equal(a, b_) for a, b_ in zip(got, P._launch_painn_stack(
                "painn_stack_train", grids, q0, stacked0, cut_p, m0.epsilon,
                True))):
            fail("painn_stack_train: outputs differ between two launches")
        print("painn_stack_train repeats bitwise (q, mu, qs, mus, qps, mups)")
        # the wrapper's own (q, mu); the launcher above for the residuals
        got = P.painn_stack_train(*grids, q0, stacked0, cut_p)
        for name, a, w in zip(("q", "mu"), got, want):
            errs.check_scaled("painn_stack_train", a, w,
                              f"DDM B=128 N=128 wrapper {name}")
        atoms = int(batch.node_mask.sum())
        stack_shape["painn_stack_train"] = (q0.shape[0], q0.shape[1], True)
        kernels.append((
            "painn_stack_train", "geossl_tpu_torch/ops/csrc/painn_stack.cu",
            "geossl_tpu/ops/painn_pallas.py:829",
            cuda_time_ms(lambda: P.painn_stack_train(*grids, q0, stacked0,
                                                     cut_p)),
            cuda_time_ms(lambda: chunked_sum(lambda *a: P.painn_stack_reference(
                *a, stacked0, cut_p, save_residuals=True), (*grids, q0), (),
                32, 6), reps=3, warmup=1),
            *painn_work("painn_stack", grids, q0, F_, R_, L_, stacked0, atoms,
                        True),
            stack_launches["painn_stack_train"]))

        # the symmetric pair at the LBA shape (phase 3d's inputs), on the
        # tensor-core basis of the other rows: each occupied unordered
        # pair's filter once (pair_work: one triangle) at the TF32 peak, the
        # message sums per ordered pair at the f32 peak; the backward's
        # filter, dWk/dbk and dphi once per unordered pair (the placed pair
        # cotangents), its elementwise terms per ordered pair
        grids, x, mu, wk0, bk0, gq, gmu = sym_case
        if pair_work(grids[0], grids[1])[2] == grids[0].numel():
            fail("painn_fwd_sym: the LBA pair grids are not symmetric")
        kernels.append((
            "painn_fwd_sym", "geossl_tpu_torch/ops/csrc/painn_fwd.cu",
            "geossl_tpu/ops/painn_pallas.py:435",
            cuda_time_ms(lambda: P.painn_message_fused_sym(
                *grids, x, mu, wk0, bk0, cut_lp, True)),
            cuda_time_ms(lambda: chunked(lambda *a: torch.cat(
                P.painn_message_fused_sym_reference(*a, wk0, bk0, cut_lp),
                dim=-1), (*grids, x, mu), (), 4), reps=3, warmup=1),
            *painn_work("painn_fwd_sym", grids, x, F_, R_),
            lba_launches_p["painn_fwd_sym"]))
    kernels.append((
        "painn_bwd_sym", "geossl_tpu_torch/ops/csrc/painn_bwd.cu",
        "geossl_tpu/ops/painn_pallas.py:540",
        cuda_time_ms(lambda: P.painn_bwd_sym(*grids, x, mu, wk0, bk0, gq, gmu,
                                             cut_lp, True)),
        cuda_time_ms(lambda: chunked_sum(
            lambda d, g, a, b_, c, xx, m, gq_, gmu_:
            P.painn_bwd_sym_reference(d, g, a, b_, c, xx, m, wk0, bk0, gq_,
                                      gmu_, cut_lp),
            (*grids, x, mu, gq, gmu), (), 2, 7), reps=2, warmup=1),
        *painn_work("painn_bwd_sym", grids, x, F_, R_),
        lba_launches_p["painn_bwd_sym"]))

    # -- 5. any --num_gaussians: #1-#5 at G = 65, 100 and 300 ----------------------
    with torch.inference_mode():
        batch, d_, e_, h_, x_ = layer0_inputs(model_mn, first(256, 128), 256, 128)
        b128, d128, e128, h128, _ = layer0_inputs(model, first(128, 128), 128,
                                                  128)
        _, d128m, e128m, h128m, _ = layer0_inputs(model_mn, first(128, 128),
                                                  128, 128)
    gauss_cases = {
        "serve256": (d_, e_, x_), "serve128": (d128, e128, h128),
        "serve128_atoms": int(b128.node_mask.sum()),
        "serve128_mn": (d128m, e128m, h128m),
        "ddm": ddm_case(128)[:4], "ddm_mn": ddm_case(128, ddm0_mn)[:4],
        "lba": lba_case[:4]}
    kernels += gaussians_path(dev, card, errs, cfg, cutoff, gauss_cases, store,
                              buckets, first, layer0_inputs, train_batch(128))

    # -- 6. the bf16 modes: #1-#4's bf16 instances ---------------------------------
    kernels += bf16_path(dev, card, errs, cfg, cutoff, gauss_cases, store,
                         buckets, first, layer0_inputs, train_batch,
                         train_buckets)

    # -- 7. any width: #1-#7 at emb = F = 256 and 96 -------------------------------
    kernels += widths_path(dev, card, errs, cfg, cutoff, gauss_cases, store,
                           buckets, first, layer0_inputs, train_batch)

    # -- 8. PaiNN at any width and any RBF count: #8-#12 -------------------------
    painn_rows = painn_widths_path(dev, card, errs, store, buckets, first,
                                   packed, train_batch, lba_batch)
    for row in painn_rows:
        if "stack_shape" in row[-1]:
            stack_shape[row[0]] = row[-1]["stack_shape"]
    kernels += painn_rows

    # -- 9. the last width refusals: #2/#4 bf16 above F = 128, #6/#7 above 256 --
    kernels += final_widths_path(dev, card, errs, cfg, cutoff, gauss_cases,
                                 store, first, train_batch, lba_batch)

    from geossl_tpu_torch.utils.flops import bound_basis

    table = []
    for name, src, replaces, ms, plain_ms, flops, nbytes, count, *extra in \
            kernels:
        if isinstance(flops, tuple):
            # (tensor-core products, elementwise): each at its own peak (the
            # bf16 instances' products at the bf16 peak), the two units
            # working at once
            peak, basis = bound_basis((extra[0] if extra else {}).get(
                "mxu", "f32"))
            t_ops = max(flops[0] / peak, flops[1] / PEAK_F32_FLOPS) * 1e3
            flops = sum(flops)
        else:
            t_ops, basis = flops / PEAK_F32_FLOPS * 1e3, "f32"
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_f32 = flops / PEAK_F32_FLOPS * 1e3
        lib, entry = KERNEL_ENTRIES[name]
        if entry is None:  # the instance of the row's shape and R
            entry = (stack_instance(*stack_shape[name])[1]
                     if lib == "painn_stack" else
                     painn_fwd_instance("_sym" in name, extra[0]["n_rbf"]))
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": count, "qm9_launches": qm9_launches.get(name, 0),
            "md17_launches": md17_launches.get(name, 0),
            "pretrain_launches": {run: per_step.get(name, 0) for run, per_step
                                  in pretrain_launches.items()},
            "baseline_graph_launches": {
                run: c.get(name, 0)
                for run, c in baseline_graph_launches.items()},
            "pairs_launches": {m: c.get(name, 0)
                               for m, c in pairs_launches.items()},
            "sealed_launches": {m: c.get(name, 0)
                                for m, c in sealed_launches.items()},
            "pair_launches": pair_launches.get(name, 0),
            "stripe": stripe_rows.get(name),
            "second_order": SECOND_ORDER.get(name),
            "max_abs_err": errs.max_abs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_basis": basis,
            "bound_ms_f32": max(t_f32, t_bytes),
            "library_ms": None, "flop": flops, "bytes": nbytes,
            "ptxas": ptxas_usage(_build.build_log(lib), entry),
            **(extra[0] if extra else {})})
        print(f"kernel {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{max(t_ops, t_bytes):.3f} ms) at its path's shape")
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
