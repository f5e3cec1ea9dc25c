#!/usr/bin/env python3
"""Drive the PyTorch port (``p2pfl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernels offs
    python3 chip_smoke.py --only exchange gossip
    python3 chip_smoke.py --only node_lora
    python3 chip_smoke.py --only wire
    python3 chip_smoke.py --only compress
    python3 chip_smoke.py --only mnist
    python3 chip_smoke.py --only cifar
    python3 chip_smoke.py --only chunked nameplate
    python3 chip_smoke.py --only chunked_target      # config 3 to 50 %
    python3 chip_smoke.py --only nameplate_target    # config 5's recipe to 0.65
    python3 chip_smoke.py --only compress_control    # broken codecs: the spread limits' control
    python3 chip_smoke.py --only kernels config7 moe
    python3 chip_smoke.py --only moe_target          # config 10's 113M MoE federation to 0.60
    python3 chip_smoke.py --only async               # the async control plane and the journal
    python3 chip_smoke.py --only megafleet           # the megafleet engine and the fleet_chunk kernel
    python3 chip_smoke.py --only round_flops         # compiled_flops over a flash round
    python3 chip_smoke.py --only trace_flash         # a flash round's device time by kind (torch.profiler)
    python3 chip_smoke.py --only trace_cifar         # config 2's round: vmapped against looped, its profiler split
    python3 chip_smoke.py --only sharded             # sharded nodes: config 5 over 4 slots a node, sharded Nodes
    python3 chip_smoke.py --only meshes              # the SPMD federations' meshes and GPipe
    python3 chip_smoke.py --only gpipe_target        # config 10's GPipe row to 0.60
    python3 chip_smoke.py --only meshes_cards        # the default mesh on every card (two or more)

Phases, each of which makes the script exit non-zero if it fails (the
``--only`` name in brackets):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``p2pfl_tpu_torch/csrc`` with ``nvcc`` (one
   per source, in parallel) and print what ``-Xptxas -v`` says of each,
   with the registers, spills and dynamic shared memory of every
   instantiation (head widths 32, 64, 128) of the forward
   (``flash_fwd_sm90``), the fused and dK/dV backward (``flash_bwd_sm90``)
   and the dQ pass (``flash_bwd_dq_sm90``);
3. [kernels] hold kernels 1-4 against their plain PyTorch versions on the
   card at the flash path's attention shape (4 nodes x batch 1, T 1024,
   32 heads, head dim 64, bf16), causal and full, on the inputs of seeds
   0-4, each element within a limit that includes the sum of the
   magnitudes of its terms (``check``); time kernel, plain version, the
   analytic bound and one PyTorch library call as a yardstick (SDPA's
   forward for the forward; for the backward SDPA's backward alone, after
   one forward with grad, against the split pair too), each kernel also
   by its device time alone and its host time a call, and the library
   call by its device time alone; then the backward at [1·32, 32768, 64]
   causal, where JAX's dispatch picks the split pass: kernels 3 + 4,
   kernel 2 and SDPA's backward, device time beside the bound (checked
   against the plain versions at T 4096); then kernels 1-4 at head
   widths 32 and 128 at config 7's shapes (``[8·8, 4096, 32]``,
   ``[8·2, 4096, 128]``, causal): held to their plain versions at seeds
   0-4, launched 220 times back to back (outputs against the first
   call's), and timed as the width-64 rows are;
4. [offs] the same for the offset-aware kernels 5-8 at a ring hop's shape
   (2 nodes x 32 heads, T_local 1024, bf16) in five visibility cases
   (diagonal, fully visible, fully masked, and two off-tile pairs, one
   with rows that see nothing inside a visited tile), both backward
   structures with a nonzero lse cotangent, seeds 0-4, exact zeros where
   no pair reaches; at head widths 32 and 128 (``[2·64, 1024, 32]``,
   ``[2·16, 1024, 128]``) the diagonal and late off-tile hops, seeds 0-4;
   then ``ring_attention(impl="flash")`` at [2, 4096, 32, 64] with R = 4
   against unsharded flash;
5. [main] the flash path at full width and depth: federated LoRA on the
   TinyLlama-architecture causal LM (22L/2048d/32h/kv4/ffn5632, vocab 4096,
   seq 1024, LoRA rank 8 with lora_mlp) through ``tiny_transformer(attn=
   "flash")`` → ``SpmdLoraFederation.from_dataset`` → ``run_round`` →
   ``run_fused(1)`` → ``evaluate``, once with the default (fused) backward
   and once with ``bwd_mode="split"``; launch counts are zeroed before and
   read after each drive, and every kernel of that drive must have run
   (``--only trace_flash``: one warm round of the fused drive under
   ``profiling.trace`` (``round_kernels``): its device time by kind
   (kernels 1-2, GEMMs, elementwise and reductions, copies), the card's
   idle share and the host's time in ``p2pfl:`` ranges, a lost profiler
   window profiled again up to ``PROFILE_TRIES`` rounds; ``--only
   round_flops``: a round's FLOPs by ``profiling.compiled_flops`` beside
   the dense-attention count, ``lora_step_flops``; what the count leaves
   out is attention's);
5b. [node_lora] the same model on the gossip Node (``NODE_LORA_DEPTH``
   of its 22 layers): 4 Nodes with
   ``LoRALearner`` through ``Simulation`` (full topology, memory
   transport), 8 training sequences a node in batches of 2, 2 rounds of 1
   epoch with the default backward (kernels 1 and 2), then one round with
   ``bwd_mode="split"`` (kernels 1, 3 and 4), counts zeroed before and
   read after each and held to the exact counts of the drive (every other
   kernel at 0); kernels 1-4 against their plain versions on one layer's
   backward inputs kept from each experiment (``[2·32, 1024, 64]``);
   every node must end on equal adapters, each frozen base
   bit-unchanged; then a 2-node pair at 2 layers (seq 256, 4 steps a
   node) on the CPU's plain versions against the card's kernels: one
   batch's adapter gradients within ``GRAD_REL_L2`` and the adapters
   after the round within the parity phase's limit; logs s/round,
   TrainStage seconds a node, peak memory and each kernel's launches;
6. [ring] the long-context path at the same widths and depth: seq 4096
   sharded over a ring of R = 4 (``federation_mesh(model_parallel=4,
   devices=["cuda:0"] * 4)``), 2 nodes x batch 1, through
   ``tiny_transformer(attn="ring_flash", mesh=...)`` and the same
   federation calls, fused backward and then split;
7. [parity] one round on the CPU (plain versions) against one round on the
   card (kernels) from the same init and data, at 2L/256d/4h/kv2 (head dim
   64): flash at seq 256, then ring flash at seq 512 with R = 4;
8. [exchange] kernel 9 (``csrc/ici_exchange.cu``, the ICI plane's shard
   transfer) against its plain version, bit for bit, on four trees: the
   MLP's six fp32 leaves, a bf16 tree, odd byte counts at unaligned
   offsets, and the leaf shapes of the 0.98B config-5 model's bf16
   weights (~2 GB); each timed with its bound, plain version and
   ``torch._foreach_copy_`` as the yardstick;
9. [gossip] the gossip Node path of ``p2pfl_tpu_torch/examples/mnist.py``
   at full MLP width: nodes on ``submesh_federation_mesh(n,
   devices=["cuda:0"] * n)``, full topology, 8192 synthetic MNIST
   samples, batch 128, 2 rounds of 1 epoch, once with
   ``WEIGHTS_PLANE="bytes"`` and once with ``"ici"``, at 2 nodes (the
   planes must end bit-equal; a control with a wrong delivery must not)
   and at 4: kernel 9 must have launched, the plane must have moved bytes
   with no fallback, alignment fix-up or failed transfer, every node must
   end on one model and the two planes' mean gap must stay in its limit.
   Every node round runs fused (each node's train step captured as a
   CUDA graph in round 0 and replayed for every batch) but in two staged
   bytes drives (2 and 4 nodes): the
   staged pair must end bit-equal to the fused pair, with no fused round
   degraded; logs TrainStage and ``fused_round`` seconds a node. Then the
   operations surface (``gossip_observed``): one more 4-Node ICI round,
   half the Nodes in the train set, under ``profiling.trace`` with a
   ``NodeMonitor`` a Node and the flight record dumped after it: the
   record's Chrome trace validates, its round report names every Node's
   stages and a critical node and stage, kernel 9's launches equal the
   shard sends, its device events are in the profile (a lost window
   retried, up to ``PROFILE_TRIES``), every Node reported
   ``device0_mem_mb`` above 0; and the CLI (``cli.main(["experiment",
   "run", "mnist", "--nodes", "2", "--rounds", "1"])``) runs on the card
   by default;
9b. [sharded] sharded nodes (``drive_sharded``): (a)
   ``ShardedNodeFederation`` at config 5's width, full-parameter (22L/
   2048d/32h/kv4, SwiGLU 5632, vocab 4096, seq 1024, ``attn="flash"``,
   ``DEFAULT_TRANSFORMER_RULES``), 2 nodes x ``model_parallel=4`` on 8
   slots of ``cuda:0``, synthetic LM data (``bench_suite.py:1165``'s
   task at this width), 2 sequences a node in batches of 1: two timed
   rounds with the fused backward (kernels 1 and 2, counts zeroed before
   and read after, held to nodes x steps x layers each), s/round, the
   per-slot resident bytes of params + Adam (equal to the port's
   ``shard_shape`` accounting and at most the full tree's / 4 x
   ``SHARDED_SLOT_SLACK``), ``max_memory_allocated``; kernel 9 timed on a
   node's sharded tree (its slot blocks, bit-exact against the plain
   version); then with ``FlashConfig(bwd_mode="split")`` (kernels 1, 3, 4)
   one round at ``model_parallel=4`` and one at 1 from the same seed,
   one after the other: bit-equal params; (b) two gossip Nodes
   (``examples/mnist.py``, config 1's MLP, full topology, 8192 samples,
   2 rounds) whose ``TorchLearner``s sit on ``(1, 2)`` slices of one
   ``submesh_federation_mesh`` over ``cuda:0`` with the MLP rules, on the
   ICI plane: kernel 9's launches equal the shard sends, no fallback,
   every delivered block bit-equal to ``exchange_plain``'s, no fused
   round degraded, and the final model bit-equal to the same two Nodes on
   one-slot learners;
10. [wire] the byte codec, gRPC and the streaming plane (``drive_wire``):
   (a) the native codec library loaded and equal to its numpy twins on
   64 MB, and ``encode_params`` of the MLP and of the config-5 bf16 tree
   (1.97 GB) on the card byte-identical to encoding their CPU copies,
   decoded onto the card bit-equal, both timed; (b) the gossip phase's
   federation over loopback gRPC (``examples/mnist.run(protocol="grpc")``)
   on ``bytes`` (weights as P2TW frames, no kernel 9) and ``ici`` (kernel
   9, no weight byte over gRPC, no fallback), and a 2-node gRPC pair
   bit-equal to the memory pair; (c) the 1.97 GB tree streamed card to
   card over gRPC in 2 MB chunks, bit-equal, timed; (d) ``examples/node1``
   and ``node2`` as two processes on the card; (e) the pair on the memory
   transport's byte path, streamed, bit-equal to the gRPC pair. Parts
   (b)-(d) need ``grpc`` and are gated off, with a line saying so, where
   it is not installed;
10b. [compress] the gossip Node's learning breadth (``drive_compress``),
   each part failing the phase on its own: (a) BASELINE config 8 (4 MLP
   Nodes over loopback gRPC, 2048/512 samples, batch 64, 2 rounds) under
   ``none``, ``int8`` and ``topk8``: weight-plane MB and messages, least
   accuracy (a compressed run within ``C8_ACC_GAP`` of ``none``'s),
   s/round; (b) the gossip phase's 4 MLP Nodes under topk8 on the ICI
   plane: kernel 9 carries the codec payloads, the only fallbacks are
   ``anchor_round_mismatch``, ``bytes_moved`` equals the transfer trees'
   bytes, one update through ``_move_codec`` equals ``encode_params`` →
   ``decode_params`` bit for bit (topk8 and int8), and kernel 9 is held
   against its plain version on that odd-length int8/int32 tree and
   timed; (c) config 5's whole tree (0.98B fp32 params) through
   ``encode_device`` under topk8 and int8 and ``decode_tk8_device``:
   seconds, GB/s, peak memory, two layers bit-equal to the CPU's run (ties
   included); (d) ``drive_node_lora``'s federation (its depth) under topk8 on the ICI
   plane, each node on its own slot: launches of kernels 1, 2 and 9,
   adapters within ``LOSSY_REL_SPREAD``, one adapter update through the
   plane equal to the byte path bit for bit, bases bit-unchanged; (e)
   ``examples/secure_mnist --mode secagg`` (4 Nodes, 2 rounds) and a
   round with one contributor crashed: every aggregate within
   ``SECAGG_ATOL`` of the FedAvg of the recorded unmasked contributions,
   mask seconds; (f) BASELINE config 9 (4 Nodes under concept shift, 5
   rounds of 2 epochs): FedPer against one global FedAvg model;
11. [mnist] ``bench.py``'s drive on the port
   (``p2pfl_tpu_torch/examples/bench_mnist.py``: 64 MLP nodes at full
   width, batch 64, fused chunks of 5 rounds to 98% test accuracy on the
   synthetic-hard task), which runs no hand kernel: it must cross 98%
   within 30 rounds with finite accuracies and losses; logs its JSON line
   (s/round, time and rounds to 98%, peak memory, FLOPs a round, MFU),
   the kernels one eager round launches and their device time
   (``torch.profiler``), a fused span as the CUDA graph ``run_fused``
   replays against the same span run eagerly (bit-equal, both timed),
   and one round of a 4-node federation on the CPU
   against one on the card from the same init and data (bf16 bounds in
   ``MNIST_*``);
12. [cifar] the CIFAR vision federation (``drive_cifar``), which runs no
   hand kernel (every count of ``_kernels.LAUNCHES`` must read 0): a
   2-node reduced-depth ResNet round on the CPU against the card (fp32 and
   bf16; one step's gradients and the round's SGD change by relative L2,
   ``PAIR_REL_L2``); BASELINE config 2 (``resnet18()``, 8 nodes of the
   synthetic-hard CIFAR-10-shaped task, batch 64, seed 3, Adam over the
   warmup-cosine schedule with kept moments) to 70 % within 25 rounds,
   each a captured ``run_fused(1, eval=True)``; config 2's throughput
   point (2048 samples a node, batch 256: s/round, MFU from
   ``round_flops``) (``--only trace_cifar``: the vmapped round (grouped
   convolutions) against a loop over the nodes, eager and captured; a
   ``torch.profiler`` split of an eager round (convolutions, GroupNorm,
   Adam's foreach passes, the aggregation, the card's idle share));
   config 2's recipe captured against
   eager, and a checkpoint saved after round 1 and restored into a fresh
   federation, each bit-equal; config 4 (10 nodes, remat, 2 Byzantine
   slots overwritten with N(0, 1)·10 each round; Krum, TrimmedMean,
   CenteredClip and FedAvg, 10 rounds each: FedAvg must end below every
   robust rule); ResNet-50 through ``examples/spmd_cifar.py --large``'s
   federation (8 nodes, 2 rounds: s/round, MFU, peak memory); ``vit()``
   (8 nodes, 2 rounds); config 6 through ``examples/heterogeneous.py``
   (FedAvg, FedProx, SCAFFOLD, FedAdam; 8 nodes, Dirichlet(0.3), 5 rounds);
13. [chunked] BASELINE config 3 through ``ChunkedFederation``
   (``drive_chunked``), no hand kernel: a reduced chunked federation on
   the CPU against the card (fp32, SGD, ``PAIR_REL_L2``); the serial,
   fused-eager and captured fused paths bit-equal on the card; then 64
   ``resnet50()`` nodes (100 classes) in chunks of 16 on Dirichlet(0.5)
   shards, batch 32, remat, Adam over the warmup-cosine schedule with
   averaged moments: a warm-up round (the chunk graph's capture), 3 timed
   rounds, MFU of model and executed FLOPs, peak memory, the serial path
   against the overlapped one, ``torch.profiler``'s split of one chunk;
14. [nameplate] BASELINE config 5 at its 32 nodes (``drive_nameplate``):
   the LM at full width, 6 of its 22 layers (``C5["smoke_depth"]``), with ``remat_policy="mlp_qkv"``, ``node_chunk=4``, batch
   1, 8 steps a round, a random base: a warm-up round and 2 timed rounds,
   then ``evaluate``; kernels 1 and 2 launched exactly as the code counts
   (every other kernel at 0) and held against their plain versions on one
   layer's backward inputs; ``mlp_qkv`` against no remat at 2 layers;
   s/round, peak memory, MFU of model and executed FLOPs;
15. [config7] BASELINE config 7 uncut (``drive_config7``): 4L/256d/8h/kv8
   (head dim 32), ffn 688, vocab 1024, batch 8; at T 512, 1024, 2048 and
   4096 the dense and flash models' forward and train step (ms, MFU of the
   dense twin's FLOPs), ``pick_attention``'s answer and the smallest T
   where flash's train step beats dense's; counted drives of 3 train steps
   in which kernels 1 and 2 launch exactly steps x layers times (kernels
   3 and 4 under ``bwd_mode="split"``; the 2-head D 128 variant at its
   width, fused and split), every other kernel 0; the bare kernels' head-dim scaling at T
   4096 (8x32, 4x64, 2x128); the D 128 variant's train step; one train
   step's gradients at T 512 on the card against the CPU's plain
   versions (``GRAD_REL_L2``);
16. [moe] BASELINE config 10's MoE rows (``drive_moe``) through
   ``SpmdLmFederation``: (a) 8 nodes of the 4L/128d 8-expert top-2 MoE,
   vocab 512, seq 128, batch 16, seed 3 to 0.60 within 12 rounds, then
   s/round and MFU; (b) the 6L/512d MoE's grad step at batch 16, seq 512
   (executed-FLOP MFU); (c) 4 nodes of that 113M model (batch 4): s/round,
   MFU, peak memory; no hand kernel (dense attention); (d) one round of 2
   nodes at 2L/64d with 4 experts, fp32, on the CPU against the card:
   routing identical on one input, params within ``C10_PAIR_REL_L2``;
17. [async] the async control plane on gossip Nodes (``drive_async``),
   every payload between Nodes on the ICI plane, each Node's learner on its
   own slot of the card: (a) one ``async_update`` through kernel 9 against
   the byte path, bit for bit with its version triple, then
   ``bench_async.py::run_threaded``'s fleet (10 MLP Nodes, synthetic MNIST
   8192/2048 seed 3, batch 64, 4 local updates, ``_make_plan``'s seed 1905:
   the last Node slow by 0.5 s inbound, the one before it crashed at its
   update 1, 1 % drops) in ``sync``, ``async`` and ``hier``
   (``HIER_CLUSTER_SIZE=4``) modes: wall seconds, least and most accuracy
   of the survivors on the whole test set (each >= 0.8), the comm counters,
   the staleness histogram, kernel 9's launches equal to the plane's shard
   sends and no fallback; (b) 6 Nodes with one sign-flip attacker,
   ``BYZ_SCREEN``, the trimmed mean and ``BYZ_SUSPICION_BETA=0.8``:
   ``byz_evicted`` fires and the survivors reach 0.8; (c) 5 Nodes, one
   edge journaled, killed by a ``RestartSpec`` and ``Node.resume``d onto
   the card: its params bit-equal to its last committed snapshot, its
   first push after the resume accepted; (d) ``SimulatedAsyncFleet`` at
   1,000 nodes x 6 updates (slow 10 % at 10x, crash 1 %, drop 1 %, seed
   1905), flat and with clusters of 32, on the card against the same fleet
   on the CPU: merge count and version sequence equal, host seconds and
   the virtual makespan;
17b. [megafleet] the megafleet engine (``drive_megafleet``), each part
   failing the phase on its own: (a) the JAX tests' ``_pair`` on the
   card, ``SimulatedAsyncFleet(1000)`` against ``MegaFleet`` on its
   exported population, flat and with clusters of 32 (merges and versions
   exact, mint times within 1e-4 flat and one link delay hier, the JAX
   tests' loss limits); (b) 500 clients, dim 8, K 8: the chunked engine
   (one ``fleet_chunk`` launch a run) at chunks 7, 48 and 256 against
   the per-event engine, flat and clusters of 32 (integers exact, params
   within ``MF_PARAM_TOL``); (c) the kernel against its plain twin (the
   same engine on the CPU) on those streams, on the median and
   trimmed-mean folds under a 5 % sign-flip attack, on three fault
   fleets of 300 (chaos knobs, every Byzantine kind, churn) and on two
   gradient-task fleets: integer and time fields equal, params within
   ``MF_PARAM_TOL``, two card runs bit-equal, launches exact; a consensus
   fleet also chunk by chunk with the counters and fold rows in device
   memory, and with PyTorch's pass A, both bit-equal to the one-launch
   run; (d) ``bench_async.py``'s megafleet_1m fleet (1M clients, dim 16,
   clusters of 1024, K 64, 4 updates, 256 events a chunk) through
   ``MegaFleet.run``: wall s, clients/s, events/s, merges and regional
   merges equal to ``BENCH_ASYNC.json``'s 976 and 62,500, time to 5 % of
   the start loss, staleness mean, peak memory, one launch for the run,
   the final model's sha256; the chunk step under ``torch.profiler`` at
   64 and 256 events (device operations a step: the kernel alone, equal
   at both), a span's device time; the 1M fleet's C 256 engine and its
   CPU copy (the plain twin) stepped to the same chunk past the first
   regional and global flushes, their carries compared as in (c), with
   the twin's time a chunk; 2,000 chunks under the kernel's own section
   timing; the rest of the run in one launch between CUDA events (the
   chunk loop's s, µs a chunk); the card's latencies and the latency
   bound; (e) ``chunk="auto"``
   on a 20k-client fleet measured once, then replayed from the cache
   file with no measurement;
17c. [meshes] the SPMD federations' meshes on slots of ``cuda:0``
   (``drive_meshes``): (a) config 10's GPipe row (``GPIPE10``: 2 nodes on
   ``pipeline_mesh(4)``, 4L/128d, batch 32 in 16 microbatches, bf16): two
   profiled rounds (accuracy, s/round, ``last_profile``), then one
   pipelined value-and-grad step against the monolithic one on the same
   batch (loss gap, the grads' relative L2 within ``GPIPE_GRAD_RTOL``,
   the pipe tax ms/ms), no hand kernel (dense attention at seq 128); (b)
   the same comparison at config 5's full width, full-parameter, flash
   at seq 1024, 2 stages of 11 layers, batch 2 in 2 microbatches: kernels
   1 and 2 launched 44 times for the pipelined step, 22 for the
   monolithic; (c) config 10's MoE row at ``expert_parallel=2`` on a
   (4, 2) mesh: each slot's expert-stack bytes equal to the
   ``shard_shape`` accounting (half the experts a slot), two rounds
   bit-equal (params and losses) to ``expert_parallel=1`` on a (4, 1)
   mesh; (d) ``main``'s LoRA federation on a (4, 4) mesh with
   ``model_parallel_base``: each slot's base bytes equal to the
   accounting, one split-backward round bit-equal to the replicated base,
   kernels 1, 3, 4 at rows x steps x layers; (e) ``bench.py``'s 64 MLP
   nodes over 8 slots against one slot: a round and a fused span
   bit-equal (params and losses), s/round of each;
18. a ``{"kernels": [...]}`` line: ``launches`` counts each kernel's main
   drive (kernels 1-4 the main drives, 5-8 the ring drives, 9 the gossip
   phase's ICI drive), ``launches_by_path`` every drive apart (for 1-4
   also each node_lora experiment, the nameplate drive and, for 1 and 2,
   the compress phase's LoRA Nodes; for 9 the wire phase's gRPC ICI drive
   and the compress phase's MLP and LoRA drives, with kernel 9's time on
   the codec tree as ``codec_tree``, and the async phase's drives,
   ``async_<mode>``, ``async_byzantine`` and ``async_resume``; for 1-4 also
   config 7's drives; for 1-4 and 9 the sharded phase's drives, and
   kernel 9's time on a sharded node's slot blocks as ``sharded_tree``;
   for 1-4 the meshes phase's pipelined step (``meshes_gpipe5``) and its
   LoRA round with the base split (``meshes_lora_tp``);
   ``fleet_chunk`` the megafleet phase's 1M run (one
   launch), its ``ms`` the kernel's time a chunk inside a span there,
   ``plain_ms`` the twin's a chunk on the CPU, ``bound_ms`` the bytes
   bound and ``latency_bound_ms`` the latency bound a chunk,
   ``max_abs_err`` the largest param gap of part (c) and of (d)'s 1M
   check, no library call),
   ``launches_by_width`` the flash kernels' launches of the whole run by
   head width, and for kernels 1-4 ``widths`` the rows at widths 32 and
   128; then the ``nvidia-smi`` line again, and last ``{"ok": true,
   "device": {...}}``.

``--only chunked_target`` runs config 3 to 50 % (at most 60 rounds),
``--only nameplate_target`` config 5's full recipe (400 Adafactor steps
pretraining the base, then at most 16 rounds to 0.65) and ``--only
moe_target`` config 10's 113M MoE federation to 0.60 (at most 15 rounds of
3 epochs): minutes each, so never by default. ``--only compress_control`` runs the compress phase's
parts (b) and (d) under two broken codecs (peers' deltas dropped; deltas
decoded onto the receiver's own params) and reads what their checks see:
the control of ``LOSSY_REL_SPREAD`` (a few minutes, never by default).

``--only gpipe_target`` runs config 10's GPipe row to 0.60 next-token
accuracy (at least 5, at most 10 profiled rounds), never by default.

``--only exchange_peer`` (never run by default: it needs two cards) times
kernel 9 storing from cuda:0 into cuda:1's memory over NVLink.
``--only meshes_cards`` (two cards or more) times the default mesh on
every visible card against a one-card mesh (``drive_meshes_cards``).

Imports only torch, numpy and ``p2pfl_tpu_torch`` (and ``grpc``, where
installed, to print its version). Weights are random, drawn from seeded
``torch.Generator``s.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FWD_SRC = "p2pfl_tpu_torch/csrc/flash_fwd_sm90.cu"
BWD_SRC = "p2pfl_tpu_torch/csrc/flash_bwd_sm90.cu"
DQ_SRC = "p2pfl_tpu_torch/csrc/flash_bwd_dq_sm90.cu"
SOURCES = {"flash_fwd": FWD_SRC, "flash_fwd_offs": FWD_SRC, "flash_bwd_dkvq": BWD_SRC,
           "flash_bwd_dkvq_offs": BWD_SRC, "flash_bwd_dkv": BWD_SRC, "flash_bwd_dkv_offs": BWD_SRC,
           "flash_bwd_dq": DQ_SRC, "flash_bwd_dq_offs": DQ_SRC,
           "ici_exchange": "p2pfl_tpu_torch/csrc/ici_exchange.cu", "fleet_chunk": "p2pfl_tpu_torch/csrc/fleet_chunk.cu"}
REPLACES = {
    "flash_fwd": "p2pfl_tpu/ops/flash_attention.py:189",
    "flash_bwd_dkvq": "p2pfl_tpu/ops/flash_attention.py:327",
    "flash_bwd_dq": "p2pfl_tpu/ops/flash_attention.py:216",
    "flash_bwd_dkv": "p2pfl_tpu/ops/flash_attention.py:294",
    "flash_fwd_offs": "p2pfl_tpu/ops/flash_attention.py:669",
    "flash_bwd_dkvq_offs": "p2pfl_tpu/ops/flash_attention.py:815",
    "flash_bwd_dq_offs": "p2pfl_tpu/ops/flash_attention.py:688",
    "flash_bwd_dkv_offs": "p2pfl_tpu/ops/flash_attention.py:786",
    "ici_exchange": "p2pfl_tpu/parallel/ici_plane.py:162",
    # no Pallas kernel: passes B-D of the XLA chunk step (_make_chunk_body)
    "fleet_chunk": "p2pfl_tpu/ops/fleet_kernels.py:787",
}
NEG_INF = -1e30
# tolerances against the plain versions on the same inputs. Both sides
# round at the same points (bf16 operands, fp32 sums, P and dS cast to
# bf16); they differ in fp32 summation order, and dQ of the fused kernel
# sums through bulk reductions in no fixed order. That moves a bf16 output
# by an ulp or two (an ulp is at most 2^-7 of the value). Each element is
# held to RTOL·|ref| + ATOL with ATOL = RTOL·rms(ref): the limit follows the
# typical value, not the few largest rows (under the causal mask the first
# query rows and the first keys' dV are many times the bulk). That limit
# does not bound a sum whose terms cancel: where the fp32 values of a P or
# dS on the two sides fall on either side of a bf16 rounding point, that
# term moves by an ulp however small the sum is. Each side rounds a term
# within half an ulp, 2^-8 of its size, so the two sides differ by at most
# 2 · 2^-8 = TERMS_TOL of the sum of the magnitudes of the terms (the plain
# versions' ``*_magnitude`` helpers), which the limit adds where the
# caller gives it. The fp32 lse is held to LSE_TOL absolute.
RTOL = 2.0 ** -6
TERMS_TOL = 2.0 * 2.0 ** -8
LSE_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


#: the prefix of the host ranges ``profiling.dispatch_span`` opens; the
#: profiler lists each also as a device-side annotation that spans the
#: range's kernels, which is not device work of its own
RANGE = "p2pfl:"
#: a profiled window the profiler lost whole is profiled again, up to this
#: many windows in all
PROFILE_TRIES = 3


def device_events(prof) -> list:
    """A profile's device work: kernels, copies and fills, without the
    ``p2pfl:`` annotations."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(RANGE)]


def range_host_ms(prof) -> float:
    """The host's milliseconds inside ``p2pfl:`` ranges (outermost ranges
    only: a range inside another adds nothing)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(RANGE))
    total, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times (inputs warm in L2 as on the
    main path, where each layer's q/k/v were just written)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_device_ms(fn, iters: int = 20) -> float:
    """Median device time of ``fn``'s work alone: a sleep kernel queued
    first keeps the card busy while the host prepares and launches, so
    the events bracket the launched work only, not the wrapper's host
    time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(got, want, terms=None) -> tuple[float, float, float]:
    """(max abs error, ATOL, worst share of the per-element limit used):
    the check passes when the share is at most 1. ``terms`` is each
    element's sum of the magnitudes of the terms that form it; without it
    the limit has no cancellation term. An all-zero reference with no
    terms (a fully masked hop) has a zero limit: only exact zeros pass."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = RTOL * want.pow(2).mean().sqrt().item()
    limit = RTOL * want.abs() + atol
    if terms is not None:
        limit = limit + TERMS_TOL * terms.float()
    share = torch.where(limit > 0, err / limit.clamp_min(1e-38),
                        torch.where(err > 0, torch.full_like(err, math.inf), torch.zeros_like(err)))
    return err.max().item(), atol, share.max().item()


def fmt(name: str, res: tuple[float, float, float], terms: bool = True) -> str:
    e, atol, used = res
    limit = f"{RTOL:g}·|ref| + {atol:.3e}" + (f" + {TERMS_TOL:g}·Σ|terms|" if terms else "")
    return f"{name} max err {e:.3e} (limit {limit}, worst element at {used:.2f} of it)"


def host_ms(fn, iters: int = 50) -> float:
    """Host time of one call (the wrapper's checks, allocations, tensor
    maps and launch), by the host clock over calls that only enqueue."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def device_times(kernel, library) -> dict:
    """A kernel's device time alone (without the wrapper's host work) and
    host time a call, and the device time of its library yardstick, where
    there is one."""
    return {"device_ms": time_device_ms(kernel), "host_ms": host_ms(kernel),
            "library_device_ms": time_device_ms(library) if library is not None else None}


def sdpa_backward(q, k, v, do, **kw):
    """SDPA's backward alone as a call: its forward runs once with grad
    here, the call is ``torch.autograd.grad`` through the kept graph."""
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, **kw)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)


def build_report(log_text: str) -> list:
    """Lines of the ``-Xptxas -v`` report worth printing, then one summary
    line per instantiation of the sm90 flash kernels (registers, spills)
    with its dynamic shared memory, which ptxas does not report."""
    from p2pfl_tpu_torch.ops import _kernels

    words = ("registers", "spill", "error", "Compiling", "warning", "Potential")
    lines = [line.strip() for line in log_text.splitlines() if any(w in line for w in words)]
    # kernel, its template flags after the head width, the shared memory of
    # an instantiation (by the width, and WITH_DQ for the backward)
    kernels = (
        ("flash_fwd_sm90", ("OFFS",), lambda d, bits: _kernels.flash_fwd_smem_bytes(d)),
        ("flash_bwd_sm90", ("OFFS", "WITH_DQ"),
         lambda d, bits: (_kernels.flash_bwd_smem_bytes if bits[1] == "1" else _kernels.flash_bwd_dkv_smem_bytes)(d)),
        ("flash_bwd_dq_sm90", ("OFFS",), lambda d, bits: _kernels.flash_bwd_dq_smem_bytes(d)),
    )
    for kernel, flags, smem_of in kernels:
        section = log_text.split(f"== {kernel}.cu", 1)[-1].split("\n== ", 1)[0]
        for entry in section.split("Compiling entry function")[1:]:
            name = entry.split("'")[1]
            m = re.search(rf"{kernel}ILi(\d+)E((?:Lb[01]E)+)", name)
            if m is None:
                continue
            d, bits = int(m.group(1)), re.findall(r"Lb([01])E", m.group(2))
            inst = ", ".join([f"D={d}"] + [f"{f}={'true' if b == '1' else 'false'}" for f, b in zip(flags, bits)])
            regs = next((w.split("Used ")[1].split(" ")[0] for w in entry.splitlines() if "Used " in w), "?")
            spill = [w.strip() for w in entry.splitlines() if "spill" in w]
            lines.append(f"{kernel}<{inst}>: {regs} registers; {'; '.join(spill) or 'no spill line'}; "
                         f"{smem_of(d, bits)} bytes of dynamic shared memory a block")
    return lines


# ---- phase 3: kernels against their plain versions ----

#: seeds of the inputs every flash kernel is checked on (timings use the first)
SEEDS = (0, 1, 2, 3, 4)


def randn_inputs(shape, seed: int, n: int = 4) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
            for _ in range(n)]


class Worst:
    """The largest error and the largest share of the limit used, per
    kernel, over the seeds and outputs checked."""

    def __init__(self):
        self.err: dict = {}
        self.share: dict = {}

    def add(self, name: str, results) -> bool:
        for e, _, used in results:
            self.err[name] = max(self.err.get(name, 0.0), e)
            self.share[name] = max(self.share.get(name, 0.0), used)
        return all(used <= 1 for _, _, used in results)


def check_flash(q, k, v, do, causal: bool, bq: int, bk: int, worst: Worst, tag: str):
    """Kernels 1-4 against their plain versions on one input: → (ok, O,
    lse, Δ). Every element within its limit, the terms' magnitudes from
    the plain helpers."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa

    o, lse = _kernels.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, bq, bk)
    r_o = check(o, o_ref, fa.flash_fwd_magnitude(q, k, v, causal, bq, bk))
    e_l = (lse - lse_ref).abs().max().item()
    ok = worst.add("flash_fwd", [r_o, (e_l, 0.0, e_l / LSE_TOL)])
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal)
    mags = fa.flash_bwd_magnitude(*args, bq, bk)
    ref = fa.flash_bwd_fused_plain(*args, bq, bk)
    res = [check(x, y, m) for x, y, m in zip(_kernels.flash_bwd_fused(*args), ref, mags)]
    ok &= worst.add("flash_bwd_dkvq", res)
    r_dq = check(_kernels.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args, bq, bk), mags[0])
    ok &= worst.add("flash_bwd_dq", [r_dq])
    res_kv = [check(x, y, m) for x, y, m in zip(_kernels.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*args, bq, bk),
                                                mags[1:])]
    ok &= worst.add("flash_bwd_dkv", res_kv)
    torch.cuda.synchronize()
    log(f"[kernels] {tag}: {fmt('O', r_o)}; lse max err {e_l:.3e} (limit {LSE_TOL}); fused "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dQ', 'dK', 'dV'), res))}; split {fmt('dQ', r_dq)}; "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dK', 'dV'), res_kv))} {'OK' if ok else 'FAIL'}")
    return ok, o, lse, delta


def time_rows(x: tuple, causal: bool, worst: Worst, bq: int, bk: int) -> dict:
    """Kernels 1-4 on one input ``x = (q, k, v, dO, O, lse, delta)``:
    kernel, plain version, the analytic bound and one PyTorch library call
    as a yardstick (SDPA's forward; SDPA's backward alone for the
    backward), each kernel also by its device time alone and its host time
    a call, the library call by its device time alone, and the split pair's
    device time. → kernel → row."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa

    q, k, v, do, o, lse, delta = x
    b, h, t, d = q.shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)  # (q, k) pairs computed
    bf16, f32 = 2, 4
    qkv_bytes = 3 * b * h * t * d * bf16
    row_bytes = b * h * t * f32
    rows = {}
    ms = time_ms(lambda: _kernels.flash_fwd(q, k, v, causal))
    plain = time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, bq, bk), iters=3, warmup=1)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal))
    bms, by = bound(qkv_bytes + b * h * t * d * bf16 + row_bytes, 4 * d * pairs)
    rows["flash_fwd"] = dict(max_abs_err=worst.err["flash_fwd"], ms=ms, plain_ms=plain,
                             bound_ms=bms, bound_by=by, library_ms=lib)
    rows["flash_fwd"].update(device_times(
        lambda: _kernels.flash_fwd(q, k, v, causal),
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)))

    lib_bwd = sdpa_backward(q, k, v, do, is_causal=causal)
    lib_bwd_ms = time_ms(lib_bwd)
    bwd_in = qkv_bytes + b * h * t * d * bf16 + 2 * row_bytes  # q, k, v, dO, lse, delta
    out1 = b * h * t * d * bf16
    args = (q, k, v, do, lse, delta, causal)
    for name, kernel, plain_fn, n_out, flops in (
        ("flash_bwd_dkvq", _kernels.flash_bwd_fused, fa.flash_bwd_fused_plain, 3, 10),
        ("flash_bwd_dq", _kernels.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
        ("flash_bwd_dkv", _kernels.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
    ):
        bms, by = bound(bwd_in + n_out * out1, flops * d * pairs)
        rows[name] = dict(
            max_abs_err=worst.err[name], ms=time_ms(lambda: kernel(*args)),
            plain_ms=time_ms(lambda: plain_fn(*args, bq, bk), iters=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=lib_bwd_ms)
        rows[name].update(device_times(lambda: kernel(*args), lib_bwd))
    # the split pair against SDPA's backward alone, device time
    rows["flash_bwd_dq"]["pair_device_ms"] = time_device_ms(lambda: _kernels.flash_bwd_split(*args))
    return rows


def check_kernels(results: dict) -> bool:
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, t, d = 4, 32, 1024, 64  # 4 nodes x batch 1 at the slice's shape
    cfg = default_flash_config(t, d)
    bq, bk = cfg.block_q, cfg.block_k
    ok = True
    for causal in (True, False):
        tag = "causal" if causal else "full"
        worst = Worst()
        for seed in SEEDS:
            q, k, v, do = randn_inputs((b, h, t, d), seed)
            good, o, lse, delta = check_flash(q, k, v, do, causal, bq, bk, worst, f"{tag} seed {seed}")
            ok &= good
            if seed == SEEDS[0]:
                timed_on = (q, k, v, do, o, lse, delta)
        limits = {name: f"worst element at {worst.share[name]:.2f} of its limit over seeds {list(SEEDS)}"
                  for name in worst.share}
        rows = time_rows(timed_on, causal, worst, bq, bk)
        for name, row in rows.items():
            log(f"[kernels] {name} {tag} [{b}x{h}, {t}, {d}] bf16: {json.dumps(row)} "
                f"limit: {limits[name]}")
        results[tag] = rows
    ok &= long_sequence(results)
    ok &= check_widths(results)
    return ok


#: kernels 1-4 at the other head widths, at config 7's attention shapes
#: (batch 8, T 4096, H·D = 256): [8·8, 4096, 32] and [8·2, 4096, 128]
WIDTH_SHAPES = {32: (8, 8, 4096), 128: (8, 2, 4096)}
#: launches queued back to back (the pattern that caught lost barrier phases)
B2B_CALLS = 200


def back_to_back(call, dq_exact: bool) -> list:
    """``call`` (a backward: → (dQ, dK, dV)) launched ``B2B_CALLS`` times
    back to back with no host synchronisation, as a drive or a timing loop
    queues them, then 20 times each behind a sleep kernel (the timing
    loop's pattern); each call's outputs against the first call's on the
    card, so nothing waits between launches: → the elements that differ,
    by output. With ``dq_exact`` false dQ (kernel 2's bulk reductions add
    in no fixed order) counts its elements past ``check``'s limit with no
    terms instead. A lost barrier phase hangs a call: run under a timeout."""
    first = call()
    ref_dq = first[0].float()
    dq_limit = RTOL * ref_dq.abs() + RTOL * ref_dq.pow(2).mean().sqrt()
    bad = torch.zeros(len(first), dtype=torch.int64, device=ref_dq.device)
    for n in range(B2B_CALLS + 20):
        if n >= B2B_CALLS:
            torch.cuda._sleep(1_000_000)
        for i, (x, ref) in enumerate(zip(call(), first)):
            if i == 0 and not dq_exact:
                bad[i] += ((x.float() - ref_dq).abs() > dq_limit).sum()
            else:
                bad[i] += (x != ref).sum()
    torch.cuda.synchronize()
    return bad.tolist()


def check_widths(results: dict) -> bool:
    """Kernels 1-4 at head widths 32 and 128 (``WIDTH_SHAPES``), causal:
    against their plain versions on the inputs of seeds 0-4, timed as the
    width-64 rows are, and launched back to back."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    ok = True
    for d, (b, h, t) in WIDTH_SHAPES.items():
        cfg = default_flash_config(t, d)
        worst = Worst()
        for seed in SEEDS:
            q, k, v, do = randn_inputs((b, h, t, d), seed)
            good, o, lse, delta = check_flash(q, k, v, do, True, cfg.block_q, cfg.block_k, worst,
                                              f"D {d} [{b}x{h}, {t}, {d}] causal seed {seed}")
            ok &= good
            if seed == SEEDS[0]:
                timed_on = (q, k, v, do, o, lse, delta)
        args = (*timed_on[:4], timed_on[5], timed_on[6], True)
        bad = {"fused": back_to_back(lambda: _kernels.flash_bwd_fused(*args), dq_exact=False),
               "split": back_to_back(lambda: _kernels.flash_bwd_split(*args), dq_exact=True)}
        good = all(n == 0 for counts in bad.values() for n in counts)
        ok &= good
        log(f"[kernels] D {d}: {B2B_CALLS + 20} back-to-back calls, elements differing from the first call "
            f"(fused dQ past the limit): {json.dumps(bad)} {'OK' if good else 'FAIL'}")
        rows = time_rows(timed_on, True, worst, cfg.block_q, cfg.block_k)
        for name, row in rows.items():
            row["limit_share"] = worst.share[name]
            log(f"[kernels] {name} D {d} causal [{b}x{h}, {t}, {d}] bf16: {json.dumps(row)}")
        results[f"D{d}"] = rows
    return ok


def long_sequence(results: dict) -> bool:
    """The backward where JAX's dispatch picks the split pass (T·D·4 >
    4 MiB): kernels 3 + 4, kernel 2 (with its zeroed fp32 dQ sum and the
    cast, the wrapper's device work) and SDPA's backward alone, device
    time, causal at [1·32, 32768, 64] bf16, each beside its bound. The
    plain versions are too slow there: kernels 2, 3 and 4 are checked
    against them at T 4096 on the same heads."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, d = 1, 32, 64
    worst = Worst()
    t = 4096
    cfg = default_flash_config(t, d)
    q, k, v, do = randn_inputs((b, h, t, d), SEEDS[0])
    ok, *_ = check_flash(q, k, v, do, True, cfg.block_q, cfg.block_k, worst, f"causal [{b}x{h}, {t}, {d}]")
    t = 32768
    q, k, v, do = randn_inputs((b, h, t, d), SEEDS[0])
    o, lse = _kernels.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    dq, dk, dv = _kernels.flash_bwd_split(*args)
    torch.cuda.synchronize()
    ok &= all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    del o, dq, dk, dv
    pairs = b * h * t * (t + 1) // 2
    tensor, rows = b * h * t * d * 2, b * h * t * 4
    row = {"shape": [b * h, t, d], "causal": True, "use_fused_by_jax_dispatch": fa._bwd_use_fused(t, d, "auto")}
    for name, fn, n_out, flops in (
        ("split_3_4", lambda: _kernels.flash_bwd_split(*args), 3, 14),
        ("fused_2", lambda: _kernels.flash_bwd_fused(*args), 3, 10),
        ("sdpa_backward", sdpa_backward(q, k, v, do, is_causal=True), 3, 10),
    ):
        bms, by = bound(4 * tensor + 2 * rows + n_out * tensor, flops * d * pairs)
        row[name] = {"device_ms": time_device_ms(fn, iters=10), "bound_ms": bms, "bound_by": by}
    log(f"[kernels] long sequence, split vs fused vs SDPA's backward (worst element at T 4096 "
        f"{max(worst.share.values()):.2f} of its limit): {json.dumps(row)} {'OK' if ok else 'FAIL'}")
    results["long_sequence"] = row
    return ok


# ---- phase 4: the offset-aware kernels against their plain versions ----

# (q_off, k_off) of one ring hop with T_local 1024: the diagonal hop, a hop
# from an earlier shard (fully visible), one from a later shard (fully
# masked), and two off-tile pairs whose mask cuts through the kernels'
# 64-row tiles at an offset the non-offset kernels never mask. In
# "offtile" every row sees key 0; in "offtile_late" (q_off < k_off) rows
# 0-31 see nothing inside the one k tile their q tile visits, which runs
# the kernels' sentinel guard (O 0, lse -1e30, P 0 in the backward)
OFFSET_CASES = {
    "diagonal": (1024, 1024), "visible": (2048, 0), "masked": (0, 1024), "offtile": (1024 + 32, 1024),
    "offtile_late": (1024, 1024 + 32),
}


def visible_pairs(b: int, h: int, t: int, q_off: int, k_off: int) -> int:
    """(q, k) pairs the hop attends: row i sees k_off + j <= q_off + i."""
    return b * h * sum(min(max(q_off + i - k_off + 1, 0), t) for i in range(t))


def seen_rows(t: int, q_off: int, k_off: int) -> int:
    """Rows of the hop's inputs the function must read: the q rows that see
    some key (i >= k_off - q_off) and the keys some row sees (j <= q_off +
    t - 1 - k_off) are equally many. A fully masked hop reads nothing: the
    offsets alone fix its outputs."""
    return min(max(q_off + t - k_off, 0), t)


def offset_mask(t: int, q_off: int, k_off: int, device) -> torch.Tensor:
    rows = q_off + torch.arange(t, device=device)[:, None]
    return rows >= k_off + torch.arange(t, device=device)[None, :]


def check_offs(q, k, v, do, q_off: int, k_off: int, bq: int, bk: int, gen, worst: Worst, tag: str):
    """Kernels 5-8 against their plain versions on one hop with a nonzero
    lse cotangent: → (ok, the kernels' arguments). Rows that see nothing
    give O exactly 0 and lse the sentinel; a fully masked hop's terms are
    all 0, so only exact zeros pass there."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa

    t = q.shape[2]
    o, lse = _kernels.flash_fwd_offs(q, k, v, q_off, k_off)
    o_ref, lse_ref = fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, bq, bk)
    r_o = check(o, o_ref, fa.flash_fwd_offs_magnitude(q, k, v, q_off, k_off, bq, bk))
    e_l = (lse - lse_ref).abs().max().item()
    ok = worst.add("flash_fwd_offs", [r_o, (e_l, 0.0, e_l / LSE_TOL)])
    dead = min(max(k_off - q_off, 0), t)  # leading rows that see nothing
    if dead:  # there O is exactly 0 and lse at the sentinel
        ok &= torch.count_nonzero(o[..., :dead, :]).item() == 0 and bool((lse[..., :dead] == NEG_INF).all())
    delta = (do.float() * o.float()).sum(-1)
    glse = torch.randn(lse.shape, generator=gen, device="cuda")
    glse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(glse), glse)
    args = (q, k, v, do, lse, delta, glse, q_off, k_off)
    mags = fa.flash_bwd_offs_magnitude(*args, bq, bk)
    ref = fa.flash_bwd_fused_offs_plain(*args, bq, bk)
    res = [check(x, y, m) for x, y, m in zip(_kernels.flash_bwd_fused_offs(*args), ref, mags)]
    ok &= worst.add("flash_bwd_dkvq_offs", res)
    dq, dk, dv = _kernels.flash_bwd_split_offs(*args)
    r_dq = check(dq, ref[0], mags[0])
    ok &= worst.add("flash_bwd_dq_offs", [r_dq])
    res_kv = [check(x, y, m) for x, y, m in zip((dk, dv), ref[1:], mags[1:])]
    ok &= worst.add("flash_bwd_dkv_offs", res_kv)
    # exact zeros where no pair reaches: dQ of the rows that see nothing,
    # dK and dV of the keys no row sees
    seen = seen_rows(t, q_off, k_off)
    ok &= torch.count_nonzero(dq[..., :dead, :]).item() == 0
    ok &= torch.count_nonzero(dk[..., seen:, :]).item() == 0 and torch.count_nonzero(dv[..., seen:, :]).item() == 0
    torch.cuda.synchronize()
    log(f"[offs] {tag}: {fmt('O', r_o)}; lse max err {e_l:.3e} (limit {LSE_TOL}); fused "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dQ', 'dK', 'dV'), res))}; split {fmt('dQ', r_dq)}; "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dK', 'dV'), res_kv))} {'OK' if ok else 'FAIL'}")
    return ok, args


def check_offs_kernels(results: dict) -> bool:
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, t, d = 2, 32, 1024, 64  # 2 nodes x batch 1, one shard of a 4096 ring
    cfg = default_flash_config(t, d)
    bq, bk = cfg.block_q, cfg.block_k
    bf16, f32 = 2, 4
    tensor_bytes, row_bytes = b * h * t * d * bf16, b * h * t * f32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    inputs = {seed: randn_inputs((b, h, t, d), seed) for seed in SEEDS}
    ok = True
    for case, (q_off, k_off) in OFFSET_CASES.items():
        pairs = visible_pairs(b, h, t, q_off, k_off)
        # bytes: the rows that must be read (q, k, v, dO and the fp32 rows
        # lse, Δ, g_lse of seen rows only), every output written once
        n_seen = seen_rows(t, q_off, k_off) * b * h
        seen_tensor, seen_row = n_seen * d * bf16, n_seen * f32
        worst = Worst()
        for seed in SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(100 + seed)
            good, case_args = check_offs(*inputs[seed], q_off, k_off, bq, bk, gen, worst,
                                         f"{case} seed {seed}")
            ok &= good
            if seed == SEEDS[0]:
                args = case_args
        q, k, v, do = args[:4]
        limits = {name: f"worst element at {worst.share[name]:.2f} of its limit over seeds {list(SEEDS)}"
                  for name in worst.share}

        # ---- timing: kernel, plain version, library yardstick, bound ----
        if case == "diagonal":
            kw = {"is_causal": True}
        elif case == "visible":
            kw = {}
        elif case.startswith("offtile"):
            # a yardstick only: SDPA gives NaN on rows that see nothing
            kw = {"attn_mask": offset_mask(t, q_off, k_off, "cuda")}
        else:
            kw = None  # no library call computes a fully masked attention
        lib_fwd = (lambda: sdpa(q, k, v, **kw)) if kw is not None else None
        lib_bwd = sdpa_backward(q, k, v, do, **kw) if kw is not None else None
        lib_b = time_ms(lib_bwd) if lib_bwd is not None else None
        rows = {}
        bms, by = bound(3 * seen_tensor + tensor_bytes + row_bytes, 4 * d * pairs)
        rows["flash_fwd_offs"] = dict(
            max_abs_err=worst.err["flash_fwd_offs"],
            ms=time_ms(lambda: _kernels.flash_fwd_offs(q, k, v, q_off, k_off)),
            plain_ms=time_ms(lambda: fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, bq, bk), iters=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=time_ms(lib_fwd) if lib_fwd is not None else None)
        rows["flash_fwd_offs"].update(device_times(
            lambda: _kernels.flash_fwd_offs(q, k, v, q_off, k_off), lib_fwd))
        bwd_in = 4 * seen_tensor + 3 * seen_row  # q, k, v, dO, lse, delta, g_lse
        for name, kernel, plain, n_out, flops in (
            ("flash_bwd_dkvq_offs", _kernels.flash_bwd_fused_offs, fa.flash_bwd_fused_offs_plain, 3, 10),
            ("flash_bwd_dq_offs", _kernels.flash_bwd_dq_offs, fa.flash_bwd_dq_offs_plain, 1, 6),
            ("flash_bwd_dkv_offs", _kernels.flash_bwd_dkv_offs, fa.flash_bwd_dkv_offs_plain, 2, 8),
        ):
            bms, by = bound(bwd_in + n_out * tensor_bytes, flops * d * pairs)
            rows[name] = dict(
                max_abs_err=worst.err[name], ms=time_ms(lambda: kernel(*args)),
                plain_ms=time_ms(lambda: plain(*args, bq, bk), iters=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=lib_b)
            rows[name].update(device_times(lambda: kernel(*args), lib_bwd))
        rows["flash_bwd_dq_offs"]["pair_device_ms"] = time_device_ms(lambda: _kernels.flash_bwd_split_offs(*args))
        for name, row in rows.items():
            log(f"[offs] {name} {case} (q_off {q_off}, k_off {k_off}) [{b}x{h}, {t}, {d}] bf16: "
                f"{json.dumps(row)} limit: {limits[name]}")
        results[case] = rows
    # kernels 5-8 at the other head widths, one hop shape each ([2·64,
    # 1024, 32], [2·16, 1024, 128]: H·D as above), the diagonal hop and
    # the one whose rows see nothing inside a visited tile, seeds 0-4
    for d_w, h_w in ((32, 64), (128, 16)):
        worst = Worst()
        for seed in SEEDS:
            x = randn_inputs((b, h_w, t, d_w), seed)
            for case in ("diagonal", "offtile_late"):
                gen = torch.Generator(device="cuda").manual_seed(100 + seed)
                good, _ = check_offs(*x, *OFFSET_CASES[case], bq, bk, gen, worst,
                                     f"D {d_w} [{b}x{h_w}, {t}, {d_w}] {case} seed {seed}")
                ok &= good
        results[f"D{d_w}"] = {name: {"max_abs_err": worst.err[name], "limit_share": worst.share[name]}
                              for name in worst.err}
        log(f"[offs] D {d_w}: {json.dumps(results[f'D{d_w}'])}")
    return ok


def time_ring(results: dict) -> bool:
    """ring_attention(impl="flash") over R = 4 shards of one card against
    unsharded flash attention on the same [2, 4096, 32, 64] bf16 inputs:
    the forward and forward + backward of both, and one launch of the
    unsharded kernels over [64, 4096, 64]; the ring's output is held
    against the unsharded one."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.attention import ring_attention
    from p2pfl_tpu_torch.ops.flash_attention import flash_attention
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh

    b, t, h, d, ring = 2, 4096, 32, 64, 4
    mesh = federation_mesh(model_parallel=ring, devices=["cuda:0"] * ring)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, g = (
        torch.randn((b, t, h, d), generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
        for _ in range(4)
    )
    ring_fn = lambda *x: ring_attention(*x, mesh, "model", impl="flash")  # noqa: E731
    with torch.no_grad():
        res = check(ring_fn(q, k, v), flash_attention(q, k, v))
    good = res[2] <= 1
    log(f"[offs] ring vs unsharded output: {fmt('O', res, terms=False)} {'OK' if good else 'FAIL'}")
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: fn(*xs).backward(g)

    def fwd(fn):
        def run():
            with torch.no_grad():
                fn(q, k, v)
        return run

    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    o, lse = _kernels.flash_fwd(qt, kt, vt, True)
    delta = (gt.float() * o.float()).sum(-1)
    row = {
        "shape": [b, t, h, d], "ring": ring,
        "ring_fwd_ms": time_ms(fwd(ring_fn), iters=10),
        "ring_fwd_bwd_ms": time_ms(fwd_bwd(ring_fn), iters=10),
        "flash_fwd_ms": time_ms(fwd(flash_attention), iters=10),
        "flash_fwd_bwd_ms": time_ms(fwd_bwd(flash_attention), iters=10),
        "kernel_flash_fwd_ms": time_ms(lambda: _kernels.flash_fwd(qt, kt, vt, True)),
        "kernel_flash_bwd_dkvq_ms": time_ms(lambda: _kernels.flash_bwd_fused(qt, kt, vt, gt, lse, delta, True)),
        "kernel_flash_bwd_dq_ms": time_ms(lambda: _kernels.flash_bwd_dq(qt, kt, vt, gt, lse, delta, True)),
        "kernel_flash_bwd_dkv_ms": time_ms(lambda: _kernels.flash_bwd_dkv(qt, kt, vt, gt, lse, delta, True)),
    }
    log(f"[offs] ring vs unsharded timing: {json.dumps(row)}")
    results["ring_vs_unsharded"] = row
    return good


# ---- phase 5: the flash path ----


#: the main phase's federation: the 22-layer LoRA model at seq 1024 on 4
#: nodes, 2 training sequences a node
MAIN = dict(nodes=4, seq=1024, depth=22)


def _main_model(bwd_mode: str) -> tuple:
    """The main phase's (config, data, model) with the flash backward
    ``bwd_mode``."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig

    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=MAIN["depth"],
        ffn_hidden=5632, lora_rank=8, lora_mlp=True, scan_layers=True,
        flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode),
    )
    data = FederatedDataset.synthetic_lm(
        vocab_size=4096, seq_len=MAIN["seq"], n_train=MAIN["nodes"] * 2, n_test=MAIN["nodes"] * 2, shift_frac=0.15
    )
    return cfg, data, tiny_transformer(seq_len=MAIN["seq"], seed=0, cfg=cfg, attn="flash")


def drive_main_path(bwd_mode: str) -> tuple[bool, dict]:
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    n_nodes, depth = MAIN["nodes"], MAIN["depth"]
    _, data, model = _main_model(bwd_mode)
    n_params = model.param_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _kernels.reset_launches()
    t0 = time.perf_counter()
    fed = SpmdLoraFederation.from_dataset(
        model, data, n_nodes=n_nodes, batch_size=1, vote=False, seed=3
    )
    first = fed.run_round()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fused = fed.run_fused(rounds=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    metrics = fed.evaluate()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)

    losses = [float(first["train_loss"])] + [float(e["train_loss"]) for e in fused]
    want = ["flash_fwd"] + (["flash_bwd_dkvq"] if bwd_mode != "split" else ["flash_bwd_dq", "flash_bwd_dkv"])
    ok = all(math.isfinite(x) for x in losses) and all(launches[k] > 0 for k in want)
    ok &= math.isfinite(metrics["test_loss"]) and 0.0 <= metrics["test_acc"] <= 1.0
    summary = {
        "bwd_mode": bwd_mode, "layers": depth, "params": n_params,
        "s_round_first": t1 - t0, "s_round_fused": t2 - t1,
        "train_losses": losses, "test_loss": metrics["test_loss"],
        "test_acc": metrics["test_acc"], "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "steps_per_round": fed._nb,
    }
    log(f"[main] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    del fed, model
    torch.cuda.empty_cache()
    return ok, summary


def drive_trace_flash() -> tuple[bool, dict]:
    """The main phase's fused drive, then one warm round of it under
    ``profiling.trace`` (``round_kernels``): device time by kind, idle
    share, host time in ``p2pfl:`` ranges (``--only trace_flash``; out of
    the default run for the call's time limit)."""
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    _, data, model = _main_model("auto")
    fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=MAIN["nodes"], batch_size=1, vote=False, seed=3)
    fed.run_round()  # warm
    torch.cuda.synchronize()
    prof = round_kernels(fed, FLASH_SPLIT)
    ok = prof["kernels"] is not None
    log(f"[trace_flash] flash round profile (warm run_round, fused backward, {smi_line()}): device ms by kind "
        f"{json.dumps(prof.get('by_kind_ms'))}, busy {prof.get('busy_ms')} of {prof['profiled_wall_ms']:.1f} "
        f"ms wall (idle share {prof.get('idle_share')}), host in p2pfl: ranges {prof['p2pfl_range_host_ms']:.1f} "
        f"ms, {prof.get('kernels')} kernels, windows lost {prof['lost_windows']} of {PROFILE_TRIES} "
        f"{'OK' if ok else 'FAIL'}")
    del fed, model
    torch.cuda.empty_cache()
    return ok, {"round_profile": prof}


def drive_round_flops() -> tuple[bool, dict]:
    """``profiling.compiled_flops`` over one warm round of the main phase's
    federation (fused backward) beside the dense-attention count
    (``lora_step_flops``). The count runs the round; it sums the aten
    products alone, and the flash kernels launch through ``ctypes``, so
    attention's products are what it leaves out."""
    from p2pfl_tpu_torch.management.profiling import compiled_flops
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    cfg, data, model = _main_model("auto")
    fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=MAIN["nodes"], batch_size=1, vote=False, seed=3)
    fed.run_round()  # warm
    counted = compiled_flops(fed.run_round)
    analytic = fed._nb * lora_step_flops(cfg, MAIN["nodes"] * MAIN["seq"], MAIN["seq"])
    ok = counted is not None and 0 < counted < analytic
    summary = {"compiled_flops": counted, "analytic_with_attention": analytic,
               "left_out": analytic - counted if counted is not None else None}
    log(f"[round_flops] a round's FLOPs: compiled_flops {counted} (no flash kernel in it), the dense-attention "
        f"count {analytic}: {summary['left_out']} left out "
        f"({summary['left_out'] / analytic if counted is not None else float('nan'):.4f}) {'OK' if ok else 'FAIL'}")
    del fed, model
    torch.cuda.empty_cache()
    return ok, summary


# ---- phase 5b: LoRA on the gossip Node (flash kernels 1-4 on the Node path) ----


#: the node_lora phase's federation: BASELINE config 5 at full width and
#: depth, 4 Nodes, 8 training sequences a node in batches of 2
NODE_LORA = dict(nodes=4, seq=1024, batch=2, n_train=32, n_test=8, lr=1e-3)
#: the Node phases' depth (of config 5's 22 layers) in the default run: the
#: layers repeat one block, and the run's time limit binds (node_lora 4
#: since the meshes phase joined the run, compress's LoRA Nodes 8)
NODE_LORA_DEPTH = 4
COMPRESS_LORA_DEPTH = 8


def _config5(depth: int, bwd_mode: str = "auto", vocab: int = 4096):
    from p2pfl_tpu_torch.models.transformer import TransformerConfig
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig

    return TransformerConfig(
        vocab_size=vocab, dim=2048, n_heads=32, n_kv_heads=4, n_layers=depth, ffn_hidden=5632,
        lora_rank=8, lora_mlp=True, flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode),
    )


def _node_lora_settings() -> None:
    """The test presets with the waits of a full-width model: a round
    holds four threads' forward and backward passes, seconds of host work
    under one interpreter lock."""
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.settings import Settings, set_test_settings

    set_test_settings()
    logger.set_level("WARNING")
    Settings.HEARTBEAT_TIMEOUT = 10.0
    Settings.VOTE_TIMEOUT = 60.0
    Settings.AGGREGATION_TIMEOUT = 300.0


def _adapters(sim) -> list:
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    return [[x.float().cpu() for x in tree_leaves(n.learner.get_parameters())] for n in sim.nodes]


def _adapter_grads(learner, x, y) -> list:
    """One batch's loss gradient for every adapter leaf of ``learner``
    (the base frozen), as fp32 on the CPU."""
    from p2pfl_tpu_torch.learning.lora import _lm_loss
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_unflatten

    paths = [p for p, _ in tree_items(learner.lora)]
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(learner.lora)]
    loss, _ = _lm_loss(tree_unflatten(dict(zip(paths, leaves))), learner.base, learner.module, x, y)
    return [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]


#: one batch's adapter gradients, card against CPU, relative L2 per leaf:
#: the kernels' ulp-level differences (and the GEMMs' summation order)
#: pass through two layers of bf16 GEMMs, so the per-element kernel limit
#: does not apply (the same limit as tests/test_torch_cuda_node.py)
GRAD_REL_L2 = 2.0 ** -4


def node_lora_pair(devices=("cpu", "cuda")) -> tuple[bool, dict]:
    """Two Nodes, 2 layers at config 5's width, seq 256, one round of 4
    steps a node: the same init and data on the CPU (plain versions) and
    on the card (kernels). One batch's adapter gradients are held to
    ``GRAD_REL_L2``; the adapters after the round to the parity phase's
    limits (2·lr a step on an element, 0.1·lr on the mean)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.lora import LoRALearner
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.transformer import CausalLM, init_params, resolve_attention
    from p2pfl_tpu_torch.ops.autotune import default_flash_config
    from p2pfl_tpu_torch.ops.tree import tree_map
    from p2pfl_tpu_torch.simulation import Simulation

    lr, seq, batch = 1e-3, 256, 2
    cfg = _config5(2)
    data = FederatedDataset.synthetic_lm(vocab_size=4096, seq_len=seq, n_train=16, n_test=2)
    attn_fn = resolve_attention("flash", config=default_flash_config(seq, cfg.head_dim))
    params = init_params(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for blk in (params[f"layer_{i}"] for i in range(cfg.n_layers)):
        for sub in (blk["attn"], blk["mlp"]):
            for dense in sub.values():
                dense["lora_b"] = torch.randn(dense["lora_b"].shape, generator=gen) * 0.02
    out = {}
    for dev in devices:
        model = TorchModel(CausalLM(cfg, attn_fn), tree_map(lambda x: x.to(dev), params), (seq,),
                           cfg.vocab_size, {"config": cfg})
        x, y = (torch.from_numpy(a[:batch]).to(dev) for a in (data.x_train, data.y_train))
        grads = _adapter_grads(LoRALearner(model, data, batch_size=batch), x, y)
        sim = Simulation(2, lambda i, shard: LoRALearner(model, shard, batch_size=batch, learning_rate=lr, seed=i),
                         data, topology="full")
        t0 = time.perf_counter()
        try:
            sim.start().learn(rounds=1, epochs=1, timeout=600)
            out[dev] = (_adapters(sim), time.perf_counter() - t0, grads)
        finally:
            sim.stop()
    (a_cpu, s_cpu, g_cpu), (a_gpu, s_gpu, g_gpu) = out[devices[0]], out[devices[-1]]
    grad_err = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(g_gpu, g_cpu))
    gap = _gaps(a_cpu[:1], a_gpu[:1])
    within = max(_gaps(a[:1], a[1:])[0] for a in (a_cpu, a_gpu))
    steps = len(data.x_train) // 2 // batch  # each node's half in batches
    ok = (grad_err <= GRAD_REL_L2 and gap[0] <= 2 * lr * steps and gap[1] <= 0.1 * lr
          and within <= 1e-4)
    summary = {"layers": 2, "seq": seq, "steps": steps, "grad_rel_l2_max": grad_err,
               "tol_grad_rel_l2": GRAD_REL_L2, "max_abs_diff": gap[0], "mean_abs_diff": gap[1],
               "tol_max": 2 * lr * steps, "tol_mean": 0.1 * lr, "within_run_max": within,
               "cpu_s": s_cpu, "cuda_s": s_gpu}
    log(f"[node_lora] pair card vs CPU {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def _lora_node_alone(learner) -> dict:
    """One Node's epoch and eval with the other Nodes idle: host seconds
    each, and the epoch's device busy time from ``torch.profiler`` (the
    kernels' summed device time; "not measured" where the profiler sees
    no device time)."""
    from torch.profiler import ProfilerActivity, profile

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    out = {"fit_s": timed(learner.fit), "evaluate_s": timed(learner.evaluate),
           "steps": learner.data.num_samples // learner.batch_size}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed(learner.fit)
    rows = [e for e in prof.key_averages() if not e.key.startswith(RANGE)]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    kernels = sum(e.count for e in rows if e.self_device_time_total > 0)
    out.update(profiled_fit_s=wall, device_busy_s=busy if busy > 0 else "not measured",
               device_idle_share=1 - busy / wall if busy > 0 else "not measured",
               kernels_a_step=kernels / out["steps"])
    return out


def drive_node_lora(depth: int = NODE_LORA_DEPTH) -> tuple[bool, dict]:
    """``LoRALearner`` on gossip Nodes at full width (``depth`` of config
    5's 22 layers: :data:`NODE_LORA_DEPTH` in the default run), the flash
    path: 4 Nodes through ``Simulation`` (full topology, memory
    transport), 2 rounds of 1 epoch with the default backward, then a
    second experiment of 1 round with the split backward (the Nodes'
    module swapped for one whose flash config says ``split``). Launch
    counts are zeroed before and read after each experiment. Every node
    must end on equal adapters (1e-4, the reference test's), each base
    bit-unchanged, and the pair must agree across CPU and card. One
    layer's backward inputs are kept from each experiment, and kernels
    1-4 are held against their plain versions on them: the Node path's
    own activations at its own shape (``[2·32, 1024, 64]``, half the
    main path's rows, so the persistent kernels run another schedule)."""
    from dataclasses import replace

    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.lora import LoRALearner
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.models.transformer import CausalLM, tiny_transformer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.simulation import Simulation

    _node_lora_settings()
    k = NODE_LORA
    n = k["nodes"]
    cfg = _config5(depth)
    data = FederatedDataset.synthetic_lm(
        vocab_size=4096, seq_len=k["seq"], n_train=k["n_train"], n_test=k["n_test"], shift_frac=0.15
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = tiny_transformer(seq_len=k["seq"], seed=0, cfg=cfg, attn="flash")
    n_params = model.param_count
    sim = Simulation(
        n, lambda i, shard: LoRALearner(model, shard, batch_size=k["batch"], learning_rate=k["lr"], seed=i),
        data, topology="full",
    )
    bases = [[x.cpu() for x in tree_leaves(node.learner.base)] for node in sim.nodes]
    steps = k["n_train"] // n // k["batch"]
    runs = {}
    recorded: dict = {}
    real_bwd = fa.flash_bwd_bhtd

    def recording_bwd(*a):
        # the first layer backward of each experiment, copied (nothing of
        # the path reads the copies)
        if mode not in recorded:
            recorded[mode] = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
        return real_bwd(*a)

    fa.flash_bwd_bhtd = recording_bwd
    try:
        sim.start()
        for mode, rounds in (("auto", 2), ("split", 1)):
            if mode == "split":
                split = CausalLM(replace(cfg, flash_config=_config5(depth, "split").flash_config))
                for node in sim.nodes:
                    node.learner.module = split
            telemetry.reset_spans()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            sim.learn(rounds=rounds, epochs=1, timeout=900)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            # per node: (steps + the eval before training) forwards a round
            # and the final eval, one backward a step; every layer
            fwd = n * depth * (rounds * (steps + 1) + 1)
            bwd = n * depth * rounds * steps
            expected = {"flash_fwd": fwd, **({"flash_bwd_dkvq": bwd} if mode == "auto" else
                                             {"flash_bwd_dq": bwd, "flash_bwd_dkv": bwd})}
            runs[mode] = {"rounds": rounds, "s_per_round": seconds / rounds, "seconds": seconds,
                          "launches": dict(_kernels.LAUNCHES), "launches_expected": expected,
                          "seconds_per_node": span_breakdown(n)}
        adapters = _adapters(sim)
        metrics = sim.evaluate()
        alone = _lora_node_alone(sim.nodes[0].learner)
        base_ok = all(
            all(torch.equal(a, b.cpu()) for a, b in zip(before, tree_leaves(node.learner.base)))
            for before, node in zip(bases, sim.nodes)
        )
    finally:
        fa.flash_bwd_bhtd = real_bwd
        sim.stop()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del sim, model, bases
    torch.cuda.empty_cache()
    spread = _gaps(adapters[:1] * (n - 1), adapters[1:])[0]
    flash_cfg = default_flash_config(k["seq"], cfg.head_dim)
    worst = Worst()
    kernels_ok = {}
    for mode, (q, kk, v, _o, _lse, do, causal, _cfg) in recorded.items():
        kernels_ok[mode] = check_flash(q, kk, v, do, causal, flash_cfg.block_q, flash_cfg.block_k, worst,
                                       f"node_lora {mode} layer backward inputs {list(q.shape)}")[0]
    del recorded
    checks = {
        # every kernel of LAUNCHES at its expected count, the others at 0
        f"launches exactly as expected ({mode})": all(
            count == r["launches_expected"].get(name, 0) for name, count in r["launches"].items())
        for mode, r in runs.items()
    }
    checks.update({
        "kernels 1-4 within their limits on each experiment's layer inputs":
            sorted(kernels_ok) == ["auto", "split"] and all(kernels_ok.values()),
        "adapters equal across nodes (1e-4)": spread <= 1e-4,
        "base bit-unchanged": base_ok,
        "metrics finite": all(math.isfinite(m["test_loss"]) for m in metrics.values()),
    })
    good, pair = node_lora_pair()
    checks["pair card vs CPU within the parity limit"] = good
    ok = all(checks.values())
    summary = {"layers": depth, "params": n_params, "nodes": n, "seq": k["seq"], "batch": k["batch"],
               "steps_per_round": steps, "runs": runs, "adapter_spread": spread, "peak_mem_gb": peak,
               "test_loss": [m["test_loss"] for m in metrics.values()], "pair": pair, "checks": checks,
               "kernel_checks_worst_share": worst.share, "kernel_checks_max_err": worst.err,
               "node_alone": alone}
    log(f"[node_lora] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    log(f"[node_lora] one node alone (split backward): {json.dumps(alone)}")
    for mode, r in runs.items():
        log(f"[node_lora] {mode}: s/round {r['s_per_round']:.3f}, TrainStage s/node "
            f"{r['seconds_per_node'].get('stage:TrainStage')}, peak {peak:.1f} GB")
        log(f"[node_lora] {mode} launches: " + json.dumps({x: v for x, v in r["launches"].items() if v}))
    return ok, summary


# ---- phase 6: the long-context ring path ----


def drive_ring_path(bwd_mode: str, depth: int) -> tuple[bool, dict]:
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    n_nodes, seq, ring = 2, 4096, 4
    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=depth,
        ffn_hidden=5632, lora_rank=8, lora_mlp=True, scan_layers=True,
        flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode),
    )
    data = FederatedDataset.synthetic_lm(
        vocab_size=4096, seq_len=seq, n_train=n_nodes * 2, n_test=n_nodes * 2, shift_frac=0.15
    )
    mesh = federation_mesh(model_parallel=ring, devices=["cuda:0"] * ring)
    model = tiny_transformer(seq_len=seq, seed=0, cfg=cfg, attn="ring_flash", mesh=mesh)
    n_params = model.param_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _kernels.reset_launches()
    t0 = time.perf_counter()
    fed = SpmdLoraFederation.from_dataset(
        model, data, n_nodes=n_nodes, batch_size=1, vote=False, seed=3
    )
    first = fed.run_round()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fused = fed.run_fused(rounds=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    metrics = fed.evaluate()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)

    losses = [float(first["train_loss"])] + [float(e["train_loss"]) for e in fused]
    steps = 2 * fed._nb  # training steps in the two rounds
    # every hop of every layer is launched, fully masked ones included
    fwd_want = depth * ring * ring * (steps + 1)  # + the eval forward
    bwd = ["flash_bwd_dkvq_offs"] if bwd_mode != "split" else ["flash_bwd_dq_offs", "flash_bwd_dkv_offs"]
    ok = all(math.isfinite(x) for x in losses) and launches["flash_fwd_offs"] == fwd_want
    ok &= all(launches[name] == depth * ring * ring * steps for name in bwd)
    ok &= all(launches[name] == 0 for name in ("flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv"))
    ok &= math.isfinite(metrics["test_loss"]) and 0.0 <= metrics["test_acc"] <= 1.0
    summary = {
        "bwd_mode": bwd_mode, "layers": depth, "params": n_params, "seq": seq, "ring": ring,
        "nodes": n_nodes, "s_round_first": t1 - t0, "s_round_fused": t2 - t1,
        "train_losses": losses, "test_loss": metrics["test_loss"],
        "test_acc": metrics["test_acc"], "launches": launches,
        "launches_fwd_offs_expected": fwd_want,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "steps_per_round": fed._nb,
    }
    log(f"[ring] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    del fed, model
    torch.cuda.empty_cache()
    return ok, summary


# ---- phase 7: one round, CPU plain versions against card kernels ----


def round_parity(attn: str = "flash", seq: int = 256, ring: int = 1) -> tuple[bool, dict]:
    """``attn="flash"``, or ``"ring_flash"`` over ``ring`` shards (a mesh
    of the CPU on the CPU, of the card on the card)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.transformer import (
        CausalLM, TransformerConfig, init_params, resolve_attention,
    )
    from p2pfl_tpu_torch.ops.autotune import default_flash_config
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    lr = 1e-3
    cfg = TransformerConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=688,
        lora_rank=8, lora_mlp=True,
    )
    data = FederatedDataset.synthetic_lm(vocab_size=512, seq_len=seq, n_train=8, n_test=8)
    params = init_params(cfg, seed=1, device="cpu")
    # lora_b starts at 0, which zeroes lora_a's first gradient; a nonzero
    # start exercises every adapter gradient in the comparison
    gen = torch.Generator().manual_seed(2)
    for blk in (params[f"layer_{i}"] for i in range(cfg.n_layers)):
        for sub in (blk["attn"], blk["mlp"]):
            for dense in sub.values():
                dense["lora_b"] = torch.randn(dense["lora_b"].shape, generator=gen) * 0.02
    flash_cfg = default_flash_config(seq // ring, cfg.head_dim)
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = federation_mesh(model_parallel=ring, devices=[dev] * ring) if attn == "ring_flash" else None
        attn_fn = resolve_attention(attn, config=flash_cfg, mesh=mesh)
        model = TorchModel(CausalLM(cfg, attn_fn), tree_map(lambda x: x.to(dev), params), (seq,),
                           cfg.vocab_size, {"config": cfg})
        fed = SpmdLoraFederation.from_dataset(
            model, data, n_nodes=4, batch_size=1, vote=False, seed=3, learning_rate=lr,
            device=dev,
        )
        t0 = time.perf_counter()
        entry = fed.run_round()
        loss = float(entry["train_loss"])
        out[dev] = (tree_map(lambda x: x.float().cpu(), fed.params), loss, time.perf_counter() - t0)
    (p_cpu, l_cpu, s_cpu), (p_gpu, l_gpu, _) = out["cpu"], out["cuda"]
    pairs = list(zip(tree_leaves(p_cpu), tree_leaves(p_gpu)))
    diffs = [(a - b).abs().max().item() for a, b in pairs]
    mean_diff = float(np.mean([(a - b).abs().mean().item() for a, b in pairs]))
    # Adam moves an adapter by about lr per step whatever the gradient's
    # size, so a bf16 rounding difference can flip the sign of a tiny
    # gradient: bound each element by 2·lr per step; the mean difference
    # and the loss must stay far below that
    steps = fed._nb
    ok = max(diffs) <= 2 * lr * steps and mean_diff <= 0.1 * lr and abs(l_cpu - l_gpu) <= 1e-2 * abs(l_cpu)
    summary = {"attn": attn, "seq": seq, "ring": ring,
               "max_abs_diff": max(diffs), "mean_abs_diff": mean_diff, "tol_max": 2 * lr * steps,
               "tol_mean": 0.1 * lr, "loss_cpu": l_cpu, "loss_cuda": l_gpu, "cpu_s": s_cpu}
    log(f"[parity] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


# ---- phase 8: kernel 9 (the ICI plane's shard transfer) ----


def exchange_trees(gen: torch.Generator) -> dict:
    """name → (sources, destinations) on the card. The unaligned tree's
    sources are views at odd offsets into one flat buffer; half its
    destinations share the sources' misalignment (the kernel's vector path
    with byte head and tail), half are whole allocations (its byte path)."""
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, init_params
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    def fresh(srcs):
        return [torch.empty_like(s) for s in srcs]

    mlp_leaves = tree_leaves(mlp(seed=0, device="cuda").params)
    bf16 = [
        torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for shape in ((4096, 2048), (2048,), (2048, 256), (8, 2048), (5632, 2048), (3, 5, 7))
    ]
    flat = torch.randint(0, 256, (1 << 20,), generator=gen, device="cuda", dtype=torch.uint8)
    spans = [(1, 1001), (3 + 4096, 17), (5 + 8192, 65537), (16 + 200000, 15), (7 + 300000, 123457)]
    odd = [flat[o:o + n] for o, n in spans]
    # dtype views need offsets that are multiples of their element size
    odd += [flat[600002:600002 + 2 * 333].view(torch.bfloat16), flat[700012:700012 + 4 * 999].view(torch.float32)]
    shadow = torch.empty_like(flat)
    odd_dst = [shadow[o:o + n] for o, n in spans] + fresh(odd[len(spans):])
    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=22, ffn_hidden=5632,
        lora_rank=8, lora_mlp=True,
    )
    big = [x.to(torch.bfloat16) for x in tree_leaves(init_params(cfg, seed=0, device="cuda"))]
    return {
        "mlp_fp32": (mlp_leaves, fresh(mlp_leaves)),
        "bf16": (bf16, fresh(bf16)),
        "odd_unaligned": (odd, odd_dst),
        "config5_bf16": (big, fresh(big)),
    }


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def check_exchange(results: dict) -> bool:
    """Kernel 9 against its plain version on each tree, bit for bit, and
    timed: median of 20 CUDA-event-timed wrapper calls; bound = (bytes
    read + bytes written) / 3.35 TB/s; the plain version (per-leaf
    ``copy_``) and ``torch._foreach_copy_`` over the same tree; and the
    device time of the kernel and of ``_foreach_copy_`` alone, without
    the host's share (:func:`time_device_ms`)."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain

    gen = torch.Generator(device="cuda").manual_seed(9)
    ok = True
    for name, (srcs, dsts) in exchange_trees(gen).items():
        refs = [torch.empty_like(d) for d in dsts]
        for d in dsts:
            d.fill_(0)
        _kernels.ici_exchange(srcs, dsts)
        exchange_plain(srcs, refs)
        torch.cuda.synchronize()
        good = all(bits_equal(d, r) and bits_equal(d, s) for d, r, s in zip(dsts, refs, srcs))
        # as values (NaN where random bytes spell one counts as equal)
        err = max((d.float() - r.float()).nan_to_num().abs().max().item() for d, r in zip(dsts, refs))
        ok &= good
        n_bytes = sum(s.numel() * s.element_size() for s in srcs)
        bms, by = bound(2 * n_bytes, 0)
        row = dict(
            max_abs_err=err, ms=time_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
            plain_ms=time_ms(lambda: exchange_plain(srcs, refs)), bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: torch._foreach_copy_(refs, srcs)),
        )
        # the kernel's device time alone and host time a call, and
        # _foreach_copy_'s device time alone
        row.update(device_times(lambda: _kernels.ici_exchange(srcs, dsts),
                                lambda: torch._foreach_copy_(refs, srcs)))
        log(f"[exchange] {name}: {len(srcs)} leaves, {n_bytes} bytes, bit-equal to the plain "
            f"version: {good}; {json.dumps(row)} "
            f"{'OK' if good else 'FAIL'}")
        results[name] = row
        del srcs, dsts, refs
    torch.cuda.empty_cache()
    # the floor of any one launch: an empty kernel's device time (a sleep
    # of 0 cycles), beside the MLP tree's bound
    empty = time_device_ms(lambda: torch.cuda._sleep(0))
    results["mlp_fp32"]["empty_launch_device_ms"] = empty
    log(f"[exchange] an empty kernel's launch: {empty:.5f} ms of device time "
        f"(the MLP tree's bound {results['mlp_fp32']['bound_ms']:.6f} ms)")
    return ok


def check_exchange_peer(results: dict) -> bool:
    """Kernel 9 across two cards (only with ``--only exchange_peer`` on a
    machine with two or more): the MLP and config-5 trees from cuda:0 into
    cuda:1's memory, bit-exact, timed like phase ``exchange``; the bound
    is the payload over one NVLink direction (450 GB/s)."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain

    if torch.cuda.device_count() < 2:
        log("[exchange_peer] needs two cards")
        return False
    src_dev, dst_dev = torch.device("cuda", 0), torch.device("cuda", 1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    ok = True
    for name, (srcs, _) in exchange_trees(gen).items():
        if name not in ("mlp_fp32", "config5_bf16"):
            continue
        dsts = [torch.empty_like(s, device=dst_dev) for s in srcs]
        refs = [torch.empty_like(d) for d in dsts]
        _kernels.ici_exchange(srcs, dsts)
        exchange_plain(srcs, refs)
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        good = all(bits_equal(d, r) for d, r in zip(dsts, refs))
        ok &= good
        n_bytes = sum(s.numel() * s.element_size() for s in srcs)
        row = dict(
            ms=time_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
            device_ms=time_device_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
            plain_ms=time_ms(lambda: exchange_plain(srcs, refs)),
            library_ms=time_ms(lambda: torch._foreach_copy_(refs, srcs)),
            nvlink_bound_ms=n_bytes / 450e9 * 1e3,
        )
        log(f"[exchange_peer] {name} cuda:0 -> cuda:1: {len(srcs)} leaves, {n_bytes} bytes, "
            f"bit-equal: {good}; {json.dumps(row)} {'OK' if good else 'FAIL'}")
        results[name] = row
    return ok


# ---- phase 9: the gossip Node path over both weights planes ----


#: limits of the gossip phase's cross-plane checks, from the readings in
#: PERF.md. Two nodes with equal shards: FedAvg of two halves is
#: exact in either arrival order, so the planes end bit-equal unless a
#: delivery is wrong. Four nodes: partial aggregates fold in arrival order
#: and Adam turns those ulps into up to a step of lr on near-zero
#: gradients, so the planes are held on the mean gap over every element:
#: it read 2.4e-6 on an H100, a wrong delivery 2.5e-2.
PAIR_MAX_GAP = 0.0
FOLD_MEAN_GAP = 5e-5


def _gaps(a: list, b: list) -> tuple[float, float]:
    """(max, mean) absolute difference over every element of two fleets'
    leaves (lists of per-node lists of fp32 CPU tensors)."""
    diffs = [(x - y).abs() for la, lb in zip(a, b) for x, y in zip(la, lb)]
    return max(d.max().item() for d in diffs), sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs)


#: the gossip and wire phases' federation: BASELINE config 1's MLP at full
#: width on one card's slots, full topology
GOSSIP_KW = dict(rounds=2, epochs=1, samples=8192, batch_size=128, device="cuda", topology="full")


#: the spans the gossip phase logs round by round
ROUND_KEYS = ("stage:TrainStage", "dispatch:fused_round", "dispatch:fused_graph_capture", "dispatch:train_epoch")


def span_breakdown(nodes: int, by_round: bool = False) -> dict:
    """Seconds per node in each stage and dispatch site of a drive, from
    the in-process spans (host clock); ``by_round`` splits each by round
    (a span's round is the last field of its trace id)."""
    from p2pfl_tpu_torch.management.telemetry import telemetry

    per: dict = {}
    for s in telemetry.spans():
        if s.kind in ("stage", "dispatch"):
            key = f"{s.kind}:{s.name}"
            rnd = s.trace_id.rsplit(":", 1)[-1] if by_round else None
            per.setdefault(key, {})
            per[key][rnd] = per[key].get(rnd, 0.0) + s.duration_ns / 1e9 / nodes
    if not by_round:
        return {k: round(d[None], 4) for k, d in sorted(per.items())}
    return {k: {r: round(v, 4) for r, v in sorted(d.items())} for k, d in sorted(per.items())}


#: the observed round's train set on 4 Nodes: half train and half wait for
#: the aggregate, so the round runs every stage of the FSM
OBSERVED_TRAIN_SET = 2
#: the NodeMonitor's period in the observed round, seconds
MONITOR_PERIOD = 0.2


def gossip_observed(kw: dict = GOSSIP_KW, nodes: int = 4) -> tuple[dict, dict]:
    """One more round of ``examples/mnist.py``'s Nodes on the ICI plane with
    the operations surface on: ``profiling.trace`` around it (its Chrome
    trace into a temporary directory), a ``NodeMonitor`` a Node reporting
    into a list, and the flight record (``dump_flight_record``) written
    after it. ``OBSERVED_TRAIN_SET`` of the Nodes train, the rest wait for
    the aggregate. Checks on the host's record: the flight record's trace
    validates (``validate_chrome_trace``); the round report has every
    Node, each with the vote, gossip and finish stages and one of train
    and wait, both kinds in the round, a start stage span a Node
    (recorded before the round counter is set, so outside the report),
    and a critical node and stage; kernel 9's launches equal the plane's
    shard sends; the profiler holds ``p2pfl:`` ranges; every Node
    reported ``device0_mem_mb`` above 0. ``torch.profiler`` records host
    ranges on the thread that profiles (here the main thread's
    ``evaluate`` calls) and the card's work from every thread (kernel 9
    launches on the gossip threads); the flight record holds every
    thread's spans. Kernel 9's device events need the profiler's window:
    a round whose window lost them is run again, up to ``PROFILE_TRIES``
    rounds (``lost_windows``)."""
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.examples import mnist as example
    from p2pfl_tpu_torch.management import profiling
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.management.node_monitor import NodeMonitor
    from p2pfl_tpu_torch.management.telemetry import FSM_STAGES, dump_flight_record, telemetry, validate_chrome_trace
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.settings import Settings

    prev = Settings.TRAIN_SET_SIZE, Settings.RESOURCE_MONITOR_PERIOD
    Settings.TRAIN_SET_SIZE, Settings.RESOURCE_MONITOR_PERIOD = OBSERVED_TRAIN_SET, MONITOR_PERIOD
    rounds, lost, k9_us = [], 0, []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for attempt in range(PROFILE_TRIES):
                ici_mod.reset_ici_stats()
                telemetry.reset_spans()
                _kernels.reset_launches()
                logger.reset_comm_metrics()
                samples: list = []
                monitors: list = []

                def start_monitors(fleet):
                    for node in fleet:
                        monitors.append(NodeMonitor(node.addr, report_fn=lambda n, m, v: samples.append((n, m, v))))
                        monitors[-1].start()

                t0 = time.perf_counter()
                try:
                    with profiling.trace(tmp) as prof:
                        out = example.run(nodes=nodes, weights_plane="ici", on_start=start_monitors,
                                          **{**kw, "rounds": 1})
                finally:
                    for monitor in monitors:
                        monitor.stop()
                wall = time.perf_counter() - t0
                launches, stats = _kernels.LAUNCHES["ici_exchange"], ici_mod.ici_stats()
                trace_path, report_path = dump_flight_record(os.path.join(tmp, f"flight{attempt}"))[:2]
                with open(trace_path) as f:
                    n_events = validate_chrome_trace(json.load(f))
                with open(report_path) as f:
                    report = next((r for r in json.load(f) if r["round"] == 0), None)
                per_node = report["per_node"] if report else {}
                stages = {n: set(info["stages_s"]) for n, info in per_node.items()}
                starts = {s.node for s in telemetry.spans() if s.kind == "stage" and s.name == FSM_STAGES[0]}
                mem = {}
                for n, metric, v in samples:
                    if metric == "device0_mem_mb":
                        mem[n] = max(mem.get(n, 0.0), v)
                device = device_events(prof)
                k9_events = [e for e in device if "ici_exchange" in e.name]
                ranges = sorted({e.name for e in prof.events() if e.name.startswith(RANGE)})
                rounds.append({
                    "wall_s": wall, "trace_events": n_events, "report": report and {
                        "wall_s": report["wall_s"], "critical_path": report["critical_path"],
                        "stages_s": {n: info["stages_s"] for n, info in per_node.items()}},
                    "nodes_with_start_stage": len(starts & set(out["addrs"])),
                    "launches_ici_exchange": launches, "shard_sends": stats["shard_sends"],
                    "fallback_bytes": stats["fallback_bytes"], "p2pfl_ranges": ranges,
                    "device_events": len(device), "ici_exchange_device_events": len(k9_events),
                    "device0_mem_mb": mem, "monitor_samples": len(samples),
                    "profile_trace_mb": os.path.getsize(prof.trace_path) / 1e6,
                    "test_acc": [m["test_acc"] for m in out["metrics"]],
                    "host_checks": {
                        "trace validates": n_events > 0,
                        "report has every Node": set(per_node) == set(out["addrs"]),
                        "every Node: vote, gossip, finish and one of train / wait": all(
                            {"VoteTrainSetStage", "GossipModelStage", "RoundFinishedStage"} <= st
                            and len(st & {"TrainStage", "WaitAggregatedModelsStage"}) == 1 for st in stages.values()),
                        "every FSM stage ran": set(FSM_STAGES[1:]) <= set().union(*stages.values())
                        and starts >= set(out["addrs"]),
                        "critical node and stage named": bool(report) and report["critical_path"]["node"] in per_node
                        and report["critical_path"]["stage"] in FSM_STAGES,
                        "kernel 9 launches == shard sends > 0": launches == stats["shard_sends"] > 0,
                        "no fallback": stats["fallback_bytes"] == 0,
                        "p2pfl: dispatch ranges in the profile": bool(ranges),
                        "every Node's device0_mem_mb > 0": set(mem) == set(out["addrs"]) and min(mem.values()) > 0,
                        "accuracy finite": all(math.isfinite(m["test_loss"]) for m in out["metrics"]),
                    },
                })
                k9_us = [e.time_range.elapsed_us() for e in k9_events][:8]
                del prof, device, k9_events, out
                if k9_us:
                    break
                lost += 1
    finally:
        Settings.TRAIN_SET_SIZE, Settings.RESOURCE_MONITOR_PERIOD = prev
    checks = {f"observed round: {k}": all(r["host_checks"][k] for r in rounds) for k in rounds[0]["host_checks"]}
    checks["observed round: kernel 9's device events in a profiled window"] = bool(k9_us)
    summary = {"rounds": rounds, "lost_windows": lost, "ici_exchange_device_us": k9_us}
    last = rounds[-1]
    log(f"[gossip] observed round ({nodes} Nodes, ici, train set {OBSERVED_TRAIN_SET}): flight-record trace "
        f"{last['trace_events']} events, critical path {json.dumps(last['report'] and last['report']['critical_path'])}; "
        f"kernel 9 {last['launches_ici_exchange']} launches, {last['shard_sends']} shard sends, "
        f"{last['ici_exchange_device_events']} device events in the profile, windows lost {lost} of {PROFILE_TRIES}; "
        f"p2pfl: ranges {last['p2pfl_ranges']}; device0_mem_mb by Node {json.dumps(last['device0_mem_mb'])}")
    return checks, summary


def cli_on_card() -> tuple[dict, dict]:
    """``python -m p2pfl_tpu_torch experiment run mnist --nodes 2 --rounds 1``
    in this process, with no ``--device``: it must return 0 and run on the
    card (each Node captures its train step as a CUDA graph, which happens
    on a CUDA device alone)."""
    from p2pfl_tpu_torch import cli
    from p2pfl_tpu_torch.management.logger import logger

    logger.reset_comm_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["experiment", "run", "mnist", "--nodes", "2", "--rounds", "1"])
    torch.cuda.synchronize()
    captures = sum(c.get("fused_graph_capture", 0) for c in logger.get_comm_metrics().values())
    summary = {"rc": rc, "s": time.perf_counter() - t0, "fused_graph_captures": captures,
               "peak_mem_mb": torch.cuda.max_memory_allocated() / 1e6}
    checks = {"cli: experiment run mnist returned 0": rc == 0,
              "cli: its 2 Nodes trained on the card (2 graph captures)": captures == 2 and summary["peak_mem_mb"] > 0}
    log(f"[gossip] cli: experiment run mnist --nodes 2 --rounds 1 (default device) {json.dumps(summary)}")
    return checks, summary


def drive_gossip() -> tuple[bool, dict]:
    """``examples/mnist.py``'s path at full MLP width.

    First 2 nodes, bytes then ici (the bytes drive also warms CUDA, cuBLAS
    and the allocator up, so no time of the pair is reported): the planes
    must end bit-equal. A control repeats the ICI pair with a delivery
    that hands each receiver its own model instead of the sender's; it
    must read far above both limits, or the checks could not see a wrong
    delivery. Then 4 nodes, bytes then ici, each with the launch counts
    zeroed before and read after, and seconds per node in every stage and
    dispatch site from its spans; their gap is held on its mean. Every
    drive runs the fused round (``Settings.ROUND_FUSED``: each node's
    train step captured as a CUDA graph in round 0 and replayed for every
    batch) but a 2-node and
    a 4-node bytes drive on the staged path: the staged pair must end
    bit-equal to the fused one, no fused round may degrade, and every
    fused node round must take the graph path."""
    import logging

    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.examples import mnist as example
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.settings import Settings, set_test_settings

    set_test_settings()
    logger.set_level("WARNING")
    failures: list = []

    class _Failed(logging.Handler):
        def emit(self, record):
            if "ICI shard transfer" in record.getMessage():
                failures.append(record.getMessage())

    kw = GOSSIP_KW

    def drive(plane: str, nodes: int, fused: bool = True) -> dict:
        ici_mod.reset_ici_stats()
        telemetry.reset_spans()
        _kernels.reset_launches()
        logger.reset_comm_metrics()
        Settings.ROUND_FUSED = fused
        try:
            out = example.run(nodes=nodes, weights_plane=plane, **kw)
        finally:
            Settings.ROUND_FUSED = True
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        comm = logger.get_comm_metrics()
        fused_counts = {name: sum(c.get(name, 0) for c in comm.values())
                        for name in ("fused_graph_capture", "fused_graph_replay", "fused_round_degraded")}
        leaves = [[x.float().cpu() for x in tree_leaves(p)] for p in out["params"]]
        return dict(
            fused=fused, s_per_round=out["round_s"], elapsed_s=out["elapsed_s"],
            test_acc=[m["test_acc"] for m in out["metrics"]],
            test_loss=[m["test_loss"] for m in out["metrics"]],
            ici_stats=ici_mod.ici_stats(), launches_ici_exchange=launches["ici_exchange"],
            within_run_max_diff=_gaps(leaves[:1] * (nodes - 1), leaves[1:])[0],
            fused_counts=fused_counts,
            graph_rounds_per_node_round=(fused_counts["fused_graph_capture"] + fused_counts["fused_graph_replay"])
            / (nodes * kw["rounds"]),
            seconds_per_node=span_breakdown(nodes), by_round=span_breakdown(nodes, by_round=True), leaves=leaves,
        )

    handler = _Failed()
    logger._logger.addHandler(handler)
    try:
        pair = {plane: drive(plane, 2) for plane in ("bytes", "ici")}
        staged_pair = drive("bytes", 2, fused=False)
        real = ici_mod.shard_transfer
        ici_mod.shard_transfer = lambda tree, filler, src, dst: tree_map(torch.clone, filler)
        try:
            control = drive("ici", 2)
        finally:
            ici_mod.shard_transfer = real
        runs = {plane: drive(plane, 4) for plane in ("bytes", "ici")}
        staged = drive("bytes", 4, fused=False)
        observed_checks, observed = gossip_observed(kw)
        cli_checks, cli_run = cli_on_card()
    finally:
        logger._logger.removeHandler(handler)
    pair_gap = _gaps(pair["bytes"]["leaves"], pair["ici"]["leaves"])
    fused_gap = _gaps(pair["bytes"]["leaves"], staged_pair["leaves"])
    fused_runs = (*runs.values(), *pair.values())
    degraded = sum(r["fused_counts"]["fused_round_degraded"] for r in (*fused_runs, control))
    control_gap = _gaps(pair["bytes"]["leaves"], control["leaves"])
    fold_gap = _gaps(runs["bytes"]["leaves"], runs["ici"]["leaves"])
    ici, byt = runs["ici"], runs["bytes"]
    stats = ici["ici_stats"]
    checks = {
        "kernel 9 launched": ici["launches_ici_exchange"] > 0 and pair["ici"]["launches_ici_exchange"] > 0,
        "bytes plane launched no kernel 9": byt["launches_ici_exchange"] == 0,
        "shard_sends > 0": stats["shard_sends"] > 0,
        "bytes_moved > 0": stats["bytes_moved"] > 0,
        "no fallback": stats["fallback_bytes"] == 0 and pair["ici"]["ici_stats"]["fallback_bytes"] == 0,
        "no alignment fix-up": stats["align_violations"] == 0,
        "no failed transfer": not failures,
        "within-run spread <= 1e-5": max(r["within_run_max_diff"] for r in (*runs.values(), *pair.values())) <= 1e-5,
        f"2 nodes: bytes vs ici max gap <= {PAIR_MAX_GAP}": pair_gap[0] <= PAIR_MAX_GAP,
        f"4 nodes: bytes vs ici mean gap <= {FOLD_MEAN_GAP}": fold_gap[1] <= FOLD_MEAN_GAP,
        "control (wrong delivery) reads above both limits":
            control_gap[0] > PAIR_MAX_GAP and control_gap[1] > 100 * FOLD_MEAN_GAP,
        "accuracy finite": all(math.isfinite(x) for r in (*runs.values(), *pair.values()) for x in r["test_loss"]),
        "2 nodes: fused vs staged bit-equal": fused_gap[0] == 0.0,
        "no fused round degraded": degraded == 0,
        "fused drives ran the graph path every round": all(r["graph_rounds_per_node_round"] == 1 for r in fused_runs),
        "staged drives took no fused round": all(
            sum(r["fused_counts"].values()) == 0 for r in (staged, staged_pair)),
        **observed_checks, **cli_checks,
    }
    ok = all(checks.values())
    for r in (*runs.values(), *pair.values(), control, staged, staged_pair):
        r.pop("leaves")
    summary = {"nodes": 4, "rounds": 2, "samples": 8192, "batch": 128, "bytes": byt, "ici": ici,
               "bytes_vs_ici_max_mean": fold_gap, "pair_bytes_vs_ici_max_mean": pair_gap,
               "pair_ici": {k: pair["ici"][k] for k in ("ici_stats", "launches_ici_exchange", "within_run_max_diff")},
               "control_vs_bytes_max_mean": control_gap, "control_within_run": control["within_run_max_diff"],
               "failed_transfer_logs": failures[:3], "checks": checks,
               "staged_bytes": staged, "pair_fused_vs_staged_max_mean": fused_gap, "fused_degraded": degraded,
               "observed": observed, "cli": cli_run}
    log(f"[gossip] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    log(f"[gossip] fused degradations {degraded}; rounds through the step graph a node a round (one "
        f"replay a batch) {[r['graph_rounds_per_node_round'] for r in fused_runs]}; of them, rounds "
        f"without a capture a node over 2 rounds "
        f"{[r['fused_counts']['fused_graph_replay'] / len(r['test_loss']) for r in fused_runs]}")
    for name, r in (("bytes fused", byt), ("ici fused", ici), ("bytes staged", staged)):
        sp = r["seconds_per_node"]
        log(f"[gossip] 4 nodes, {name}: TrainStage {sp.get('stage:TrainStage')} s/node, fused_round "
            f"{sp.get('dispatch:fused_round')}, train_epoch {sp.get('dispatch:train_epoch')}, rounds "
            f"{r['s_per_round']} s (earlier staged runs, PERF.md §5: TrainStage 0.76-1.75 s/node, train_epoch "
            f"0.50-1.32); "
            f"by round {json.dumps({k: v for k, v in r['by_round'].items() if k in ROUND_KEYS})}")
    return ok, summary


# ---- phase 10: the byte codec, gRPC and the streamed full model ----


def _timed_s(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def wire_codec(results: dict) -> bool:
    """Part (a): the native library is loaded and equals its numpy twins
    bit for bit on 64 MB of random bytes (CRC32C) and 16 M fp32 values
    (int8 quantize and dequantize); ``encode_params`` of the MLP and of
    the 0.98B model's bf16 weights (``exchange_trees``' config-5 tree,
    1.97 GB) on the card gives the bytes of encoding their CPU copies, and
    decoding onto the card gives bit-equal leaves; encode and decode timed
    (host clock to a synchronize) with their GB/s."""
    from p2pfl_tpu_torch import native
    from p2pfl_tpu_torch.learning import weights as tw
    from p2pfl_tpu_torch.models.vision import mlp

    t0 = time.perf_counter()
    loaded = native.NATIVE  # builds the library on first use: not in the timings below
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    vals = (rng.standard_normal(16 << 20) * 3.0).astype(np.float32)
    (crc, crc_s), (crc_np, crc_np_s) = _timed_s(lambda: native.crc32c(data)), _timed_s(lambda: native.crc32c_np(data))
    (q, scale), (q_np, scale_np) = native.quantize(vals), native.quantize_np(vals)
    deq_equal = native.dequantize(q, scale).tobytes() == native.dequantize_np(q, scale).tobytes()
    checks = {
        "native library loaded (NATIVE)": loaded,
        "crc32c == numpy twin on 64 MB": crc == crc_np,
        "quantize == numpy twin on 16 M fp32": scale == scale_np and np.array_equal(q, q_np),
        "dequantize == numpy twin": deq_equal,
    }
    out = {"native_library": native.library_path().name, "native_load_s": build_s, "crc32c_64MB_ms": crc_s * 1e3,
           "crc32c_np_64MB_ms": crc_np_s * 1e3}
    gen = torch.Generator(device="cuda").manual_seed(9)
    big = exchange_trees(gen)["config5_bf16"][0]
    trees = {"mlp_fp32": mlp(seed=0, device="cuda").params,
             "config5_bf16": {f"leaf_{i:04d}": t for i, t in enumerate(big)}}
    for name, tree in trees.items():
        n_bytes = sum(t.numel() * t.element_size() for _, t in tw.named_leaves(tree)[1])
        # the median of 5 encodes of the MLP (the first pays start-up),
        # one of the 1.97 GB tree
        timings = [_timed_s(lambda: tw.encode_params(tree)) for _ in range(5 if n_bytes < 1 << 30 else 1)]
        payload, enc_s = timings[0][0], statistics.median(t for _, t in timings)
        cpu_copy = {k: v.cpu() for k, v in tw.named_leaves(tree)[1]}
        same_bytes = tw.encode_params(cpu_copy) == payload
        del cpu_copy
        timings = [_timed_s(lambda: tw.decode_params(payload, device="cuda")) for _ in range(len(timings))]
        flat, dec_s = timings[0][0], statistics.median(t for _, t in timings)
        equal = all(bits_equal(flat[k], v) and flat[k].device.type == "cuda" for k, v in tw.named_leaves(tree)[1])
        checks[f"{name}: card encode == CPU-copy encode"] = same_bytes
        checks[f"{name}: decode onto the card bit-equal"] = equal
        out[name] = {"leaves": len(flat), "bytes": n_bytes, "payload_bytes": len(payload),
                     "encode_ms": enc_s * 1e3, "encode_GBps": n_bytes / enc_s / 1e9,
                     "decode_ms": dec_s * 1e3, "decode_GBps": n_bytes / dec_s / 1e9}
        del payload, flat
    del trees, big
    torch.cuda.empty_cache()
    results["codec"] = {**out, "checks": checks}
    ok = all(checks.values())
    log(f"[wire] codec: {json.dumps(results['codec'])} {'OK' if ok else 'FAIL'}")
    return ok


def wire_stream(results: dict) -> bool:
    """Part (c): the 0.98B model's bf16 weights (1.97 GB), card to card,
    once over loopback gRPC: larger than ``GRPC_MAX_MESSAGE_MB`` (512),
    so only the stream plane carries it, in 2 MB chunks, with the gRPC
    deadline raised for this send alone. One stream, no unary fallback,
    every leaf bit-equal at the receiver (decoded onto the card as its
    chunks arrive); wall time, MB/s, chunks, the receiver's scratch peak
    and the growth of host peak RSS."""
    import resource

    from p2pfl_tpu_torch.commands import HeartbeatCommand
    from p2pfl_tpu_torch.communication.grpc_transport import GrpcProtocol
    from p2pfl_tpu_torch.communication.message import WeightsEnvelope
    from p2pfl_tpu_torch.learning import weights as tw
    from p2pfl_tpu_torch.settings import Settings

    gen = torch.Generator(device="cuda").manual_seed(9)
    big = exchange_trees(gen)["config5_bf16"][0]
    tree = {f"leaf_{i:04d}": t for i, t in enumerate(big)}
    n_bytes = sum(t.numel() * t.element_size() for t in big)
    got: dict = {}

    class Capture:
        @staticmethod
        def get_name() -> str:
            return "add_model"

        def execute(self, source, round, *args, update=None, **kwargs):  # noqa: A002
            got["update"] = update

    sender, receiver = GrpcProtocol(), GrpcProtocol()
    for proto in (sender, receiver):
        # heartbeats keep the edge alive through the send (a Node adds this)
        proto.add_command(HeartbeatCommand(proto.heartbeater))
    receiver.add_command(Capture())
    receiver.receive_device = lambda: torch.device("cuda")
    prev = (Settings.GRPC_TIMEOUT, Settings.WIRE_CHUNK_MB)
    Settings.GRPC_TIMEOUT, Settings.WIRE_CHUNK_MB = 600.0, 2.0
    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()

    # host RSS sampled every 10 ms through the send: the peak over the
    # resident size before it (the process's own high-water mark was set
    # by the codec part)
    peak = {"rss": 0}
    sampling = threading.Event()

    def sample() -> None:
        while not sampling.is_set():
            peak["rss"] = max(peak["rss"], rss())
            time.sleep(0.01)

    card_before = {"allocated_gb": torch.cuda.memory_allocated() / 1e9, "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                   "threads": threading.active_count()}
    sent, wall, rss0 = False, float("nan"), rss()
    sampler = threading.Thread(target=sample, daemon=True)
    try:
        sender.start()
        receiver.start()
        connected = sender.connect(receiver.get_address())
        tw.reset_wire_stats()
        env = WeightsEnvelope(sender.get_address(), 0, "add_model", tw.ModelUpdate(tree, ["sender"], 1))
        if connected:
            rss0 = rss()
            sampler.start()
            sent, wall = _timed_s(lambda: sender.send(receiver.get_address(), env))
    finally:
        sampling.set()
        if sampler.is_alive():
            sampler.join()
        Settings.GRPC_TIMEOUT, Settings.WIRE_CHUNK_MB = prev
        sender.stop()
        receiver.stop()
    stats = sender.wire_stats
    flat = getattr(got.get("update"), "decoded_flat", None) or {}
    equal = sorted(flat) == sorted(tree) and all(
        flat[k].device.type == "cuda" and bits_equal(flat[k], v) for k, v in tree.items())
    checks = {
        "connected": connected,
        "send acknowledged": bool(sent),
        "payload above GRPC_MAX_MESSAGE_MB": n_bytes > Settings.GRPC_MAX_MESSAGE_MB * 1024 * 1024,
        "stream_sends == 1": stats["stream_sends"] == 1,
        "stream_fallback_unary == 0": stats["stream_fallback_unary"] == 0,
        "every leaf bit-equal on the receiver's card": equal,
    }
    out = {"leaves": len(tree), "bytes": n_bytes, "wall_s": wall, "MBps": n_bytes / wall / 1e6,
           "chunks": stats["stream_chunks"], "wire_bytes": stats["weights_bytes"],
           "receiver_scratch_peak_bytes": tw.wire_stats()["stream_peak_scratch_bytes"],
           "host_peak_rss_growth_bytes": peak["rss"] - rss0, "sender_error": sender.last_stream_error,
           "before_send": card_before, "checks": checks}
    del tree, big, flat, got, env
    torch.cuda.empty_cache()
    results["stream"] = out
    ok = all(checks.values())
    log(f"[wire] stream: {json.dumps(out)} {'OK' if ok else 'FAIL'}")
    return ok


def wire_demo(results: dict) -> bool:
    """Part (d): ``python -m p2pfl_tpu_torch.examples.node1`` and ``node2``
    as two processes on the card over a real socket, each under a timeout
    of its own: both exit 0 and node2 prints its accuracy."""
    import tempfile
    from pathlib import Path

    from p2pfl_tpu_torch.communication.address import free_port

    root = Path(__file__).resolve().parent
    port = str(free_port())
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log1:
        # node1's output goes to a file: a pipe nobody drains could fill
        # and block it while node2 runs
        n1 = subprocess.Popen([sys.executable, "-m", "p2pfl_tpu_torch.examples.node1", port, "--timeout", "150"],
                              cwd=root, stdout=log1, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 90
            while n1.poll() is None and time.monotonic() < deadline:
                log1.seek(0)
                if "listening" in log1.read():
                    break
                time.sleep(0.2)
            n2 = subprocess.run([sys.executable, "-m", "p2pfl_tpu_torch.examples.node2", port, "--rounds", "2"],
                                cwd=root, capture_output=True, text=True, timeout=150)
            n1.wait(timeout=60)
        finally:
            if n1.poll() is None:
                n1.kill()
                n1.wait()
        log1.seek(0)
        out1 = log1.read()
    done = [ln for ln in n2.stdout.splitlines() if ln.startswith("done: ")]
    checks = {
        "node1 started": "listening" in out1,
        "node2 exit 0": n2.returncode == 0,
        "node1 exit 0": n1.returncode == 0,
        "node2 printed its accuracy": bool(done) and "test_acc" in done[-1],
    }
    results["demo"] = {"node2": done[-1] if done else n2.stdout[-500:] + n2.stderr[-1500:],
                       "node1_tail": out1.strip().splitlines()[-1:] if out1 else [],
                       "wall_s": time.perf_counter() - t0, "checks": checks}
    ok = all(checks.values())
    log(f"[wire] demo: {json.dumps(results['demo'])} {'OK' if ok else 'FAIL'}")
    return ok


def drive_wire() -> tuple[bool, dict]:
    """The byte codec, gRPC and the streaming plane on the card, parts
    (a)-(e). gRPC's parts (b)-(d) run only where ``grpc`` is installed,
    and say so on one line otherwise.

    (b) ``examples/mnist.run(protocol="grpc")`` with the gossip phase's
    federation (4 nodes on one card's slots, full topology, 8192 samples,
    batch 128, 2 rounds of 1 epoch), once on ``bytes`` (weights cross gRPC
    as P2TW, no kernel 9) and once on ``ici`` (kernel 9 carries them, no
    weight byte crosses gRPC, no fallback), each with its spread, losses
    and seconds per node in each stage; and a 2-node pair over gRPC held
    against the same pair on the memory transport to ``PAIR_MAX_GAP``.
    (e) that pair on the memory transport's byte path
    (``MEMORY_WIRE_CODEC=True``, ``WIRE_STREAM_THRESHOLD`` 0.5 MB so the
    0.94 MB MLP streams): bit-equal to the gRPC pair, streams counted."""
    import importlib.util

    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.examples import mnist as example
    from p2pfl_tpu_torch.learning import weights as tw
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.settings import Settings, set_test_settings

    set_test_settings()
    logger.set_level("WARNING")
    have_grpc = importlib.util.find_spec("grpc") is not None
    results: dict = {"grpc_installed": have_grpc}
    ok = wire_codec(results)

    def drive(protocol: str, plane: str, nodes: int) -> dict:
        ici_mod.reset_ici_stats()
        telemetry.reset_spans()
        logger.reset_comm_metrics()
        tw.reset_wire_stats()
        _kernels.reset_launches()
        out = example.run(nodes=nodes, weights_plane=plane, protocol=protocol, **GOSSIP_KW)
        torch.cuda.synchronize()
        leaves = [[x.float().cpu() for x in tree_leaves(p)] for p in out["params"]]
        comm = logger.get_comm_metrics()
        return dict(
            s_per_round=out["round_s"], elapsed_s=out["elapsed_s"],
            test_loss=[m["test_loss"] for m in out["metrics"]], test_acc=[m["test_acc"] for m in out["metrics"]],
            weights_bytes=sum(w["weights_bytes"] for w in out.get("wire_stats", [])),
            stream_sends=sum(w["stream_sends"] for w in out.get("wire_stats", [])),
            control_msgs=sum(w["control_msgs"] for w in out.get("wire_stats", [])),
            stream_recv=sum(m.get("stream_recv", 0) for m in comm.values()),
            codec=tw.wire_stats(), ici_stats=ici_mod.ici_stats(),
            launches_ici_exchange=_kernels.LAUNCHES["ici_exchange"],
            within_run_max_diff=_gaps(leaves[:1] * (nodes - 1), leaves[1:])[0],
            seconds_per_node=span_breakdown(nodes), leaves=leaves,
        )

    checks: dict = {}
    runs: dict = {}
    # the pairs first: when the phase runs alone, the first drive pays
    # cuBLAS and allocator start-up, which would land in a 4-node fleet
    runs["memory_pair"] = drive("memory", "bytes", 2)
    if have_grpc:
        import grpc
        from google import protobuf

        log(f"[wire] grpc: installed (grpc {grpc.__version__}, protobuf {protobuf.__version__})")
        runs["grpc_pair"] = drive("grpc", "bytes", 2)
        runs["grpc_bytes"] = drive("grpc", "bytes", 4)
        runs["grpc_ici"] = drive("grpc", "ici", 4)
    else:
        log("[wire] grpc: not installed on this machine")
    prev = (Settings.MEMORY_WIRE_CODEC, Settings.WIRE_STREAM_THRESHOLD)
    Settings.MEMORY_WIRE_CODEC, Settings.WIRE_STREAM_THRESHOLD = True, 0.5
    try:
        runs["memory_codec_pair"] = drive("memory", "bytes", 2)
    finally:
        Settings.MEMORY_WIRE_CODEC, Settings.WIRE_STREAM_THRESHOLD = prev
    codec_pair = runs["memory_codec_pair"]
    byte_ref = runs.get("grpc_pair", runs["memory_pair"])
    codec_gap = _gaps(byte_ref["leaves"], codec_pair["leaves"])
    checks["(e) byte path bit-equal to the " + ("gRPC" if have_grpc else "memory") + " pair"] = codec_gap[0] == 0.0
    checks["(e) streams counted"] = codec_pair["stream_recv"] > 0 and codec_pair["codec"]["stream_peak_scratch_bytes"] > 0
    if have_grpc:
        byt, ici = runs["grpc_bytes"], runs["grpc_ici"]
        pair_gap = _gaps(runs["grpc_pair"]["leaves"], runs["memory_pair"]["leaves"])
        results["pair_grpc_vs_memory_max_mean"] = pair_gap
        checks["(b) bytes: weight bytes over gRPC"] = byt["weights_bytes"] > 0
        checks["(b) bytes: no kernel 9 launch"] = byt["launches_ici_exchange"] == 0
        checks["(b) ici: kernel 9 launched"] = ici["launches_ici_exchange"] > 0
        checks["(b) ici: no weight byte over gRPC"] = ici["weights_bytes"] == 0 and ici["control_msgs"] > 0
        checks["(b) ici: no fallback"] = ici["ici_stats"]["fallback_bytes"] == 0 and ici["ici_stats"]["shard_sends"] > 0
        checks[f"(b) pair gRPC vs memory max gap <= {PAIR_MAX_GAP}"] = pair_gap[0] <= PAIR_MAX_GAP
        ok &= wire_stream(results)
        ok &= wire_demo(results)
    checks["within-run spread <= 1e-5"] = max(r["within_run_max_diff"] for r in runs.values()) <= 1e-5
    checks["losses finite"] = all(math.isfinite(x) for r in runs.values() for x in r["test_loss"])
    for r in runs.values():
        r.pop("leaves")
    results.update(runs=runs, codec_pair_vs_byte_ref_max_mean=codec_gap, checks=checks)
    ok &= all(checks.values())
    log(f"[wire] {json.dumps({k: v for k, v in results.items() if k not in ('codec', 'stream', 'demo')})} "
        f"{'OK' if ok else 'FAIL'}")
    return ok, results


# ---- phase 11: bench.py's MNIST path (no hand kernel) ----


#: the mnist phase's CPU-vs-card round: 4 nodes, the bench's batch 64,
#: 4 Adam steps at lr 1e-3. Adam moves an element by about lr a step
#: whatever its gradient's size, so a bf16 rounding difference can flip a
#: near-zero gradient's sign: each element within 2·lr a step, the mean
#: difference far below one step, the loss to 1%, the accuracy within
#: two test examples a node
MNIST_LR, MNIST_NODES, MNIST_STEPS = 1e-3, 4, 4


def mnist_parity() -> tuple[bool, dict]:
    """One round of a 4-node MLP federation at full width on the CPU (the
    plain path) and on the card, from the same init and data."""
    from p2pfl_tpu_torch.examples.bench_mnist import BATCH, HARD_TASK
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.vision import MLP, mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    n = MNIST_NODES
    params = mlp(seed=1, device="cpu").params
    data = FederatedDataset.synthetic_mnist(n_train=n * MNIST_STEPS * BATCH, n_test=n * 64, **HARD_TASK)
    out = {}
    for dev in ("cpu", "cuda"):
        model = TorchModel(MLP(), tree_map(lambda x: x.to(dev), params), (28, 28, 1))
        fed = SpmdFederation.from_dataset(
            model, data, n_nodes=n, batch_size=BATCH, vote=False, seed=3, keep_opt_state=True,
            learning_rate=MNIST_LR, device=dev,
        )
        entry = fed.run_round(eval=True)
        out[dev] = (tree_map(lambda x: x.float().cpu(), fed.params), float(entry["train_loss"]),
                    float(entry["test_acc"]), fed._nb, fed.y_test.numel())
    (p_cpu, l_cpu, a_cpu, steps, n_test), (p_gpu, l_gpu, a_gpu, _, _) = out["cpu"], out["cuda"]
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu))]
    worst = max(d.max().item() for d in diffs)
    mean = sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs)
    checks = {
        f"max <= 2·lr·steps ({2 * MNIST_LR * steps:g})": worst <= 2 * MNIST_LR * steps,
        f"mean <= 0.1·lr ({0.1 * MNIST_LR:g})": mean <= 0.1 * MNIST_LR,
        "loss within 1%": abs(l_cpu - l_gpu) <= 1e-2 * abs(l_cpu),
        "accuracy within 2 examples a node": abs(a_cpu - a_gpu) <= 2 * n / n_test,
    }
    summary = {"nodes": n, "steps": steps, "max_abs_diff": worst, "mean_abs_diff": mean,
               "loss_cpu": l_cpu, "loss_cuda": l_gpu, "acc_cpu": a_cpu, "acc_cuda": a_gpu, "checks": checks}
    return all(checks.values()), summary


def round_kernels(fed, split=None) -> dict:
    """Kernels one warm ``run_round`` (no eval) launches on the card, from
    ``profiling.trace`` (``torch.profiler``, its Chrome trace into a
    temporary directory): their count and device time, the busy time (the
    union of their intervals) and the card's idle share of the round's
    wall time, the host's time in ``p2pfl:`` dispatch ranges, and with
    ``split`` the device time by kind (``kernel_split``). A window the
    profiler lost whole (no device event) is profiled again on the next
    round, up to ``PROFILE_TRIES`` rounds: ``lost_windows`` counts them;
    ``kernels`` is None when all were lost."""
    from p2pfl_tpu_torch.management import profiling

    fed.run_round()
    torch.cuda.synchronize()
    lost = 0
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(PROFILE_TRIES):
            with profiling.trace(tmp) as prof:
                t0 = time.perf_counter()
                fed.run_round()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            device = device_events(prof)
            if device:
                break
            lost += 1
        trace_mb = os.path.getsize(prof.trace_path) / 1e6
    launch_calls = sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    out = {"source": "torch.profiler (profiling.trace)", "lost_windows": lost, "profiled_wall_ms": wall * 1e3,
           "p2pfl_range_host_ms": range_host_ms(prof), "launch_calls": launch_calls or None,
           "trace_mb": trace_mb}
    if not device:
        return {**out, "kernels": None, "device_ms": None}
    by, total, busy, _, top = kernel_split(prof, split or SPLIT)
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    out.update(kernels=len(kernels), copies_and_fills=len(device) - len(kernels),
               device_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3, busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3), top_kernels_ms=top)
    if split is not None:
        out["by_kind_ms"] = dict(sorted(by.items(), key=lambda kv: -kv[1]))
    return out


def graph_vs_eager(fed, rounds: int) -> tuple[bool, dict]:
    """One fused span of ``rounds`` rounds with eval from the federation's
    state, eagerly (``spmd_rounds_fused``) and as the captured CUDA graph
    that ``run_fused`` replays: the params, losses and accuracies must be
    bit-equal. Each is timed twice after a warm call (host clock to a
    synchronize); the federation's own state is not advanced."""
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel.spmd import _CapturedSpan, spmd_rounds_fused

    perms, mask, sel_idx = fed._fused_inputs(rounds, 1)

    def eager():
        return spmd_rounds_fused(
            fed.params, fed.opt_state, fed.x_all, fed.y_all, perms, mask, fed._samples, sel_idx,
            x_test=fed.x_test, y_test=fed.y_test, **fed._round_kwargs(), **fed._algo_kwargs(0),
        )

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    want = eager()
    eager_s = [timed(eager)[1] for _ in range(2)]
    span = _CapturedSpan(fed, perms, mask, sel_idx, True)
    got = span.run(fed, perms, mask, sel_idx)
    graph_s = [timed(lambda: span.run(fed, perms, mask, sel_idx))[1] for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(want[0]), tree_leaves(got[0])))
    same &= torch.equal(want[2], got[2]) and torch.equal(want[3], got[3])
    summary = {"rounds": rounds, "bit_equal": same, "eager_s_per_round": [t / rounds for t in eager_s],
               "graph_s_per_round": [t / rounds for t in graph_s]}
    del span
    return same, summary


def drive_mnist() -> tuple[bool, dict]:
    """``bench.py``'s drive through ``examples/bench_mnist.run()`` on the
    card: it must cross 98% within ``MAX_ROUNDS`` with every accuracy and
    loss finite, and run no hand kernel (the path has none). Then, on a
    federation of the same configuration, the kernels of one eager round
    (``round_kernels``) and a captured span against the eager one
    (``graph_vs_eager``); last the CPU-vs-card round (``mnist_parity``)."""
    from p2pfl_tpu_torch.examples import bench_mnist
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    _kernels.reset_launches()
    line = bench_mnist.run()
    hand = sum(_kernels.LAUNCHES.values())
    log(f"[mnist] bench line: {json.dumps(line)}")
    fed = SpmdFederation.from_dataset(
        mlp(), FederatedDataset.mnist(None, **bench_mnist.HARD_TASK), n_nodes=bench_mnist.N_NODES,
        batch_size=bench_mnist.BATCH, vote=False, seed=3, keep_opt_state=True,
    )
    per_round = round_kernels(fed)
    graph_ok, graph = graph_vs_eager(fed, bench_mnist.CHUNK)
    del fed
    par_ok, parity = mnist_parity()
    busy = per_round["device_ms"]
    checks = {
        "crossed 98% within MAX_ROUNDS": line["reached_acc"] >= bench_mnist.TARGET_ACC
        and line["rounds_to_target"] <= bench_mnist.MAX_ROUNDS,
        "accuracies and losses finite": all(math.isfinite(x) for x in line["accuracy_curve"] + line["train_losses"]),
        "no hand kernel launched": hand == 0,
        "card round agrees with the CPU round": par_ok,
        "captured span bit-equal to the eager span": graph_ok,
    }
    summary = {
        "s_per_round": line["sec_per_round"], "time_to_98_s": line["value"],
        "rounds_to_98": line["rounds_to_target"], "peak_memory_bytes": line["peak_memory_bytes"],
        "flops_per_round": line["flops_per_round"], "mfu": line["mfu"], "device": line["device"],
        "round_kernels": per_round,
        "busy_share_of_steady_round": busy / (line["sec_per_round"] * 1e3) if busy is not None else None,
        "graph_vs_eager": graph, "parity": parity, "checks": checks,
    }
    ok = all(checks.values())
    log(f"[mnist] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


# ---- [cifar] the vision federation: BASELINE configs 2, 4 and 6, ResNet-50, the ViT ----

#: config 2's synthetic-hard CIFAR-10-shaped task (``bench_suite.py:359-409``)
CIFAR_HARD = dict(dim=(32, 32, 3), modes=8, noise=0.7, proto_scale=0.5)
#: config 2: 8 nodes, 1024 samples a node, batch 64, seed 3; Adam over a
#: warmup-cosine schedule (peak 3e-3, 32 warmup steps, decay over 400 to
#: 1e-4) with kept moments; up to 25 rounds to 70 %
C2 = dict(nodes=8, per_node=1024, batch=64, seed=3, peak=3e-3, warmup=32, decay=400, end=1e-4,
          target=0.70, max_rounds=25)
#: config 2's throughput point: 2048 samples a node at batch 256
C2_THROUGHPUT = dict(per_node=2048, batch=256, rounds=3)
#: config 4 (``bench_suite.py:601-649``): 10 nodes, 2 Byzantine, remat
C4 = dict(nodes=10, byz=2, per_node=512, batch=64, rounds=10, trim=2, clip_tau=3.0, seed=3)
C4_TASK = dict(dim=(32, 32, 3), modes=2, noise=0.5, proto_scale=0.7)
#: ResNet-50 through ``examples/spmd_cifar.py --large``; the ViT at its defaults
R50_ARGS = ["--large", "--nodes", "8", "--samples", str(8 * 2048), "--batch-size", "64"]
R50_ROUNDS = VIT_ROUNDS = 2
#: config 6 through ``examples/heterogeneous.py``: 4 algorithms, 8 nodes,
#: Dirichlet(0.3), 5 rounds
C6_ARGS = ["--nodes", "8", "--rounds", "5", "--alpha", "0.3"]
#: the CPU-vs-card pair: a reduced-depth ResNet (stages (1, 1), full width)
#: on 2 nodes, 4 SGD steps of 16 images; one step's gradients and the 4
#: steps' parameter change held by relative L2 (SGD: the change is the
#: gradients' sum, so it carries no sign flips of a first Adam step). The
#: fp32 limit is set from the per-convolution check (``_conv_gaps``, H100):
#: each convolution's forward, dgrad and wgrad alone agree with the CPU's
#: to 3e-6 with TF32 off (2.5e-4 to 7.8e-4 with it on), while the whole
#: pair reads 1.3e-4 / 1.7e-4 (the chunked pair 4.4e-4) off and 3.0e-3 /
#: 5.0e-3 on: the gap grows along the backward, not in one convolution.
#: 2^-10 lies between: the TF32 mutation fails it (``cifar_pair``). bf16
#: reads 3.5e-3 / 5.5e-3
CIFAR_PAIR = dict(nodes=2, steps=4, batch=16, lr=0.05)
PAIR_REL_L2 = {"float32": 2.0 ** -10, "bfloat16": 2.0 ** -6}
#: one fp32 convolution's pass alone, card against CPU: TF32 off reads at
#: most 2.9e-6 and TF32 on at least 2.5e-4 in its worst pass (H100)
CONV_REL_L2 = 2.0 ** -14


def _rel_l2(a: list, b: list) -> float:
    num = math.sqrt(sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a, b)))
    return num / math.sqrt(sum(float(x.double().square().sum()) for x in a))


def _sync_s(fn):
    """(result, seconds) of ``fn()`` on the host clock, ended by a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _pair_errors(dtype: str, devices=("cpu", "cuda")) -> tuple[float, float, int]:
    """(gradient rel L2, change rel L2, steps a round) of the 2-node
    reduced-depth ResNet round in ``dtype`` on ``devices[1]`` against
    ``devices[0]``, from one init and one data."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.vision import ResNet, init_resnet_params
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.parallel import spmd

    n, steps, bs = CIFAR_PAIR["nodes"], CIFAR_PAIR["steps"], CIFAR_PAIR["batch"]
    data = FederatedDataset.synthetic_mnist(n_train=n * steps * bs, n_test=n * 16, **CIFAR_HARD)
    module = ResNet((1, 1), dtype=getattr(torch, dtype))
    params = init_resnet_params(module, (32, 32, 3), 1, torch.device("cpu"))
    res: dict = {}
    for dev in devices:
        model = TorchModel(module, tree_map(lambda x: x.to(dev), params), (32, 32, 3))
        fed = spmd.SpmdFederation.from_dataset(
            model, data, n_nodes=n, batch_size=bs, vote=False, seed=3, optimizer="sgd",
            learning_rate=CIFAR_PAIR["lr"], device=dev,
        )
        x, y = fed.x_all[:, :bs], fed.y_all[:, :bs]
        _, grads = spmd._value_and_grad(spmd._node_loss(module, 0.0), fed.params, x, y)
        before = [t.clone() for t in tree_leaves(fed.params)]
        fed.run_round()
        res[dev] = ([g.float().cpu() for g in tree_leaves(grads)],
                    [(a - b).float().cpu() for a, b in zip(tree_leaves(fed.params), before)], fed._nb)
    (g_cpu, d_cpu, _), (g_card, d_card, nb) = res[devices[0]], res[devices[1]]
    return _rel_l2(g_cpu, g_card), _rel_l2(d_cpu, d_card), nb


def _conv_gaps() -> dict:
    """Each convolution of the pair's model alone, card against CPU: the
    inputs of every ``vision._conv`` call of one forward of the 2 nodes on
    the CPU, then each convolution vmapped over the nodes on the CPU and
    on the card with one seeded cotangent, with TF32 off and on. Gives,
    for each (False, True), the relative L2 of each convolution's forward, dgrad and
    wgrad."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models import vision
    from p2pfl_tpu_torch.models.vision import ResNet, init_resnet_params

    n, bs = CIFAR_PAIR["nodes"], CIFAR_PAIR["batch"]
    data = FederatedDataset.synthetic_mnist(n_train=n * 4 * bs, n_test=n * 16, **CIFAR_HARD)
    module = ResNet((1, 1), dtype=torch.float32)
    params = init_resnet_params(module, (32, 32, 3), 1, torch.device("cpu"))
    x = torch.from_numpy(data.x_train[: n * bs]).reshape(n, bs, 32, 32, 3)
    calls, plain = [], vision._conv

    def recording(x_, kernel, stride, dt, bias=None):
        calls.append((x_.detach().clone(), kernel.detach().clone(), stride))
        return plain(x_, kernel, stride, dt, bias)

    vision._conv = recording
    try:
        with torch.no_grad():
            for i in range(n):
                module(params, x[i])
    finally:
        vision._conv = plain
    per_node = len(calls) // n
    gen = torch.Generator().manual_seed(0)
    out: dict = {False: [], True: []}
    for c in range(per_node):
        xs = torch.stack([calls[i * per_node + c][0] for i in range(n)])
        ks = torch.stack([calls[i * per_node + c][1] for i in range(n)])
        stride = calls[c][2]

        def passes(dev, cot=None):
            xd, kd = xs.to(dev).requires_grad_(True), ks.to(dev).requires_grad_(True)
            y = torch.func.vmap(lambda a, b: plain(a, b, stride, torch.float32))(xd, kd)
            cot = torch.randn(y.shape, generator=gen) if cot is None else cot
            dx, dk = torch.autograd.grad(y, (xd, kd), cot.to(dev))
            return cot, [t.detach().cpu() for t in (y, dx, dk)]

        cot, ref = passes("cpu")
        for tf32 in out:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                got = passes("cuda", cot)[1]
            finally:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            out[tf32].append({name: _rel_l2([a], [b]) for name, a, b in zip(("forward", "dgrad", "wgrad"), ref, got)})
    return out


def cifar_pair(devices=("cpu", "cuda")) -> tuple[bool, dict]:
    """The package's fp32 on the card. Importing it turned both TF32 flags
    off, and they are still off. A 2-node reduced-depth ResNet round on the
    CPU (the plain path) against the same round on the card, from one init
    and one data, in fp32 and bf16: one step's gradients
    (``_value_and_grad`` on one batch) and the parameter change of the
    round's 4 SGD steps, each by relative L2 within ``PAIR_REL_L2``. Each
    of its convolutions' passes alone within ``CONV_REL_L2`` (``_conv_gaps``).
    Then the mutation: with TF32 turned on in the card's convolutions and
    matmuls, the fp32 pair must exceed its limit and a convolution's pass
    its own."""
    out: dict = {"tf32_off_after_import": not (torch.backends.cudnn.allow_tf32
                                               or torch.backends.cuda.matmul.allow_tf32)}
    ok = out["tf32_off_after_import"]
    for dtype in PAIR_REL_L2:
        grad_err, step_err, nb = _pair_errors(dtype, devices)
        good = grad_err <= PAIR_REL_L2[dtype] and step_err <= PAIR_REL_L2[dtype] and nb == CIFAR_PAIR["steps"]
        ok &= good
        out[dtype] = {"grad_rel_l2": grad_err, "change_rel_l2": step_err, "limit": PAIR_REL_L2[dtype],
                      "steps": nb, "ok": good}
    gaps = _conv_gaps()
    worst = {tf32: max(max(row.values()) for row in rows) for tf32, rows in gaps.items()}
    good = worst[False] <= CONV_REL_L2
    ok &= good
    out["convs"] = {"tf32_off": gaps[False], "tf32_on": gaps[True], "limit": CONV_REL_L2,
                    "worst_off": worst[False], "worst_on": worst[True], "ok": good}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        grad_err, step_err, _ = _pair_errors("float32", devices)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    caught = max(grad_err, step_err) > PAIR_REL_L2["float32"] and worst[True] > CONV_REL_L2
    ok &= caught
    out["float32_tf32_on"] = {"grad_rel_l2": grad_err, "change_rel_l2": step_err,
                              "limit": PAIR_REL_L2["float32"], "conv_worst": worst[True], "caught": caught}
    return ok, out


def looped_value_and_grad(node_loss, params: dict, x, y, anchor=None, remat: bool = False):
    """``spmd._value_and_grad`` with the nodes as a loop inside the same
    program: each node's forward is a plain call on its own params (a view
    of the stacked leaves, ``unbind``) and its channels-last bf16 batch, one
    backward of the summed losses. The conv comparison swaps it in."""
    from torch.utils.checkpoint import checkpoint

    from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten

    paths = [p for p, _ in tree_items(params)]
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]

    def losses(*lv):
        out = []
        for i, row in enumerate(zip(*(v.unbind(0) for v in lv))):
            a = None if anchor is None else tree_map(lambda t: t[i], anchor)
            out.append(node_loss(tree_unflatten(dict(zip(paths, row))), x[i], y[i], a))
        return torch.stack(out)

    with torch.enable_grad():
        per = checkpoint(losses, *leaves, use_reentrant=False) if remat else losses(*leaves)
        grads = torch.autograd.grad(per.sum(), leaves)
    return per.detach(), tree_unflatten(dict(zip(paths, grads)))


def conv_ways(fed, rounds: int = 2) -> dict:
    """Seconds of one ResNet-18 round (no eval) two ways, in turns
    (vmapped, looped, looped, vmapped): the round program as it is (the
    nodes vmapped: grouped convolutions, ``groups`` = nodes) and with
    :func:`looped_value_and_grad` in place of ``_value_and_grad``; each
    eagerly (``run_round``, one untimed round, then ``rounds`` timed) and as
    a captured CUDA graph (``run_fused(1)``: the capture, then ``rounds``
    timed replays)."""
    from p2pfl_tpu_torch.parallel import spmd

    vmapped = spmd._value_and_grad
    times: dict = {f"{w}_{m}": [] for w in ("vmapped", "looped") for m in ("eager", "captured")}
    try:
        for way in ("vmapped", "looped", "looped", "vmapped"):
            spmd._value_and_grad = vmapped if way == "vmapped" else looped_value_and_grad
            fed.run_round()
            for _ in range(rounds):
                times[f"{way}_eager"].append(_sync_s(fed.run_round)[1])
            fed._spans.clear()
            fed.run_fused(1)
            for _ in range(rounds):
                times[f"{way}_captured"].append(_sync_s(lambda: fed.run_fused(1))[1])
            fed._spans.clear()
    finally:
        spmd._value_and_grad = vmapped
    return {k: {"s_per_round": t, "median": statistics.median(t)} for k, t in times.items()}


#: kernel-name keys of the profiler split (first match wins)
SPLIT = (
    ("conv", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop", "nchwToNhwc", "nhwcToNchw")),
    ("group_norm", ("group_norm", "GroupNorm", "RowwiseMoments", "ComputeFusedParams", "Compute1dBackward",
                    "ComputeInternalGradients", "ComputeBackwardFusedParams", "GammaBeta")),
    ("optimizer_foreach", ("multi_tensor", "foreach")),
    ("gemm", ("gemm", "gemv", "cutlass", "sm90_")),
    ("elementwise", ("elementwise_kernel", "reduce_kernel", "index_elementwise")),
)
#: the kinds of a config-5 flash round's device work (``round_kernels``):
#: the hand kernels, cuBLAS's GEMMs, PyTorch's elementwise and reduction
#: kernels; copies and fills are ``copies_fills``, the rest ``other``
FLASH_SPLIT = (
    ("flash_kernels_1_2", ("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd_dq_sm90")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "sm90_")),
    ("elementwise_reductions", ("elementwise", "reduce_kernel", "index_", "softmax", "Norm", "norm", "foreach",
                                "multi_tensor", "cat_", "Cat", "scatter", "gather", "embedding", "fill")),
)


def kernel_split(prof, split=SPLIT) -> tuple[dict, float, float, int, dict]:
    """A profile's device kernels: (ms by kind of ``split``, the first
    kind whose keys the name holds; the sum of the kernels' times, the
    time the card was busy (the union of their intervals: kernels may
    overlap), the count, the six costliest kernels' ms)."""
    events = device_events(prof)
    by: dict = {}
    top: dict = {}
    for e in events:
        kind = next((k for k, keys in split if any(s in e.name for s in keys)), None)
        if kind is None:
            kind = "copies_fills" if e.name.startswith(("Memcpy", "Memset")) else "other"
        ms = e.time_range.elapsed_us() / 1e3
        by[kind] = by.get(kind, 0.0) + ms
        top[e.name[:70]] = top.get(e.name[:70], 0.0) + ms
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:6])
    return by, sum(by.values()), busy / 1e3, len(events), top


def round_split(fed) -> dict:
    """``torch.profiler``'s split of one eager ResNet-18 round (no eval)
    after a warm one: device milliseconds by kind of kernel (convolutions,
    GroupNorm, the optimizer's foreach passes, other GEMMs, elementwise, the rest) and
    of the six costliest kernels, the aggregation's own device time
    (``_aggregate`` and the diffusion profiled apart on the round's
    output), and the card's idle share of the round's wall time (the
    union of the kernels' intervals: they may overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from p2pfl_tpu_torch.ops.tree import tree_map
    from p2pfl_tpu_torch.parallel import spmd

    fed.run_round()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_s(fed.run_round)
    by, total, busy, n_events, top = kernel_split(prof)
    if not n_events:
        return {"source": "torch.profiler (no device activity seen)", "wall_ms": wall * 1e3}
    mask, sel = fed._mask_inputs(fed._effective_mask())
    with profile(activities=[ProfilerActivity.CUDA]) as agg_prof:
        agg = spmd._aggregate([fed.params], mask, fed._samples, sel, fed.aggregator, fed.trim)
        tree_map(lambda a: a[None].expand(fed.n, *a.shape).clone(), agg)
        torch.cuda.synchronize()
    agg_ms = kernel_split(agg_prof)[1]
    return {"source": "torch.profiler", "wall_ms": wall * 1e3, "kernel_ms_sum": total, "busy_ms": busy,
            "kernels": n_events, "by_kind_ms": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": top,
            "aggregation_ms (profiled apart)": agg_ms, "idle_share": 1 - busy / (wall * 1e3)}


def _config2_fed(seed: int = 0, per_node: int = C2["per_node"], batch: int = C2["batch"], recipe: bool = True):
    """Config 2's federation: ``resnet18(seed)`` on 8 nodes of the
    synthetic-hard CIFAR-10-shaped task; the recipe (``recipe``) is Adam
    over the warmup-cosine schedule with kept moments, else the default
    Adam at 1e-3 (the throughput point, as ``bench_suite.py`` builds it)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.optimizers import adam, warmup_cosine_decay_schedule
    from p2pfl_tpu_torch.models.vision import resnet18
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    data = FederatedDataset.synthetic_mnist(n_train=C2["nodes"] * per_node, n_test=1024, **CIFAR_HARD)
    kw = dict(n_nodes=C2["nodes"], batch_size=batch, vote=False, seed=C2["seed"])
    if recipe:
        sched = warmup_cosine_decay_schedule(0.0, C2["peak"], C2["warmup"], C2["decay"], C2["end"])
        kw.update(tx=adam(sched), keep_opt_state=True)
    return SpmdFederation.from_dataset(resnet18(seed=seed), data, **kw)


def config2_target() -> tuple[bool, dict]:
    """Config 2 to 70 %: each round one ``run_fused(1, eval=True)`` (the
    recipe is capturable: the first round captures the round program as a
    CUDA graph, the others replay it), the accuracy read each round, up
    to 25 rounds; the seconds include the capture."""
    fed = _config2_fed()
    torch.cuda.reset_peak_memory_stats()
    curve, losses = [], []
    rounds_to = seconds_to = None
    t0 = time.perf_counter()
    for r in range(C2["max_rounds"]):
        entry = fed.run_fused(1, eval=True)[0]
        acc = float(entry["test_acc"])
        curve.append(acc)
        losses.append(float(entry["train_loss"]))
        if acc >= C2["target"]:
            rounds_to, seconds_to = r + 1, time.perf_counter() - t0
            break
    out = {"rounds_to_70": rounds_to, "seconds_to_70": seconds_to, "accuracy_curve": curve,
           "train_losses": losses, "steps_a_round": fed._nb, "captured": fed._capturable(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return rounds_to is not None and all(map(math.isfinite, curve + losses)), out


def config2_throughput() -> dict:
    """Config 2's throughput point: 2048 samples a node at batch 256, the
    default Adam; s/round of eager rounds after a warm one, and MFU from
    ``round_flops`` over the bf16 peak."""
    fed = _config2_fed(per_node=C2_THROUGHPUT["per_node"], batch=C2_THROUGHPUT["batch"], recipe=False)
    fed.run_round()
    torch.cuda.reset_peak_memory_stats()
    secs = [_sync_s(fed.run_round)[1] for _ in range(C2_THROUGHPUT["rounds"])]
    s = statistics.median(secs)
    flops = fed.round_flops()
    return {"s_per_round": secs, "median_s": s, "flops_per_round": flops, "mfu": flops / s / PEAK_BF16_FLOPS,
            "steps_a_round": fed._nb, "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def config2_graph_and_resume() -> tuple[bool, dict]:
    """On config 2's recipe: a one-round span captured as a CUDA graph
    against the same span run eagerly (``graph_vs_eager``, bit-equal), and
    a checkpoint: save after round 1, restore into a fresh federation (other
    init), and round 2 must be bit-equal to the run that never stopped
    (params, Adam state, loss), the restored state on the card."""
    import tempfile

    from p2pfl_tpu_torch.ops.tree import tree_leaves

    graph_ok, graph = graph_vs_eager(_config2_fed(), 1)
    a = _config2_fed()
    a.run_round()
    with tempfile.TemporaryDirectory() as tmp:
        a.save(tmp)
        want = a.run_round()["train_loss"]
        b = _config2_fed(seed=1)
        b.restore(tmp)
    on_card = all(x.is_cuda for x in tree_leaves(b.params))
    got = b.run_round()["train_loss"]
    state = lambda f: torch.utils._pytree.tree_leaves((f.params, f.opt_state))  # noqa: E731
    same = torch.equal(want, got) and all(torch.equal(x, y) for x, y in zip(state(a), state(b)))
    resume = {"bit_equal": same, "round": b.round, "restored_on_card": on_card}
    return graph_ok and same and on_card and b.round == 2, {"graph_vs_eager": graph, "resume": resume}


def config4() -> tuple[bool, dict]:
    """Config 4: 10 nodes with ``remat``, the first 2 slots overwritten
    with N(0, 1)·10 before every round (a generator seeded 0 for every
    leaf, the same every round: JAX's one fixed key for every leaf, so
    leaves of one shape get the same noise); 10 rounds each of Krum, TrimmedMean
    (trim 2), CenteredClip (τ 3) and FedAvg, the accuracy after the last
    and s/round of rounds 2-10. FedAvg, the undefended control, must end
    below every robust rule."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import resnet18
    from p2pfl_tpu_torch.ops.tree import tree_map
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    n, byz = C4["nodes"], C4["byz"]
    data = FederatedDataset.synthetic_mnist(n_train=n * C4["per_node"], n_test=1024, **C4_TASK)
    results = {}
    for agg in ("krum", "trimmed_mean", "clip", "fedavg"):
        fed = SpmdFederation.from_dataset(
            resnet18(), data, n_nodes=n, batch_size=C4["batch"], vote=False, aggregator=agg,
            trim=C4["trim"], clip_tau=C4["clip_tau"], seed=C4["seed"], remat=True,
        )
        secs = []
        for _ in range(C4["rounds"]):

            def attack(x):
                # a generator seeded afresh for every leaf: JAX draws every
                # leaf from one key, so leaves of one shape get one noise
                gen = torch.Generator(fed.device).manual_seed(0)
                x = x.clone()
                x[:byz] = torch.randn(x.shape[1:], generator=gen, device=x.device, dtype=x.dtype) * 10.0
                return x

            fed.params = tree_map(attack, fed.params)
            secs.append(_sync_s(fed.run_round)[1])
        results[agg] = {"acc": fed.evaluate()["test_acc"], "s_per_round": statistics.mean(secs[1:])}
        del fed
    fedavg = results["fedavg"]["acc"]
    ok = all(fedavg < results[a]["acc"] for a in ("krum", "trimmed_mean", "clip"))
    return ok, results


def resnet50_rounds() -> tuple[bool, dict]:
    """ResNet-50 at 100 classes through ``examples/spmd_cifar.py --large``'s
    federation (8 nodes resident, 2048 samples a node, batch 64, Dirichlet
    0.5): 2 rounds, each ``run_round`` + ``evaluate`` as the example runs
    them; s/round, MFU of the round and peak memory."""
    from p2pfl_tpu_torch.examples import spmd_cifar

    fed = spmd_cifar.make_federation(spmd_cifar.parse_args(R50_ARGS))
    torch.cuda.reset_peak_memory_stats()
    secs, accs = [], []
    for _ in range(R50_ROUNDS):
        _, s = _sync_s(fed.run_round)
        secs.append(s)
        accs.append(fed.evaluate()["test_acc"])
    flops = fed.round_flops()
    out = {"s_per_round": secs, "flops_per_round": flops, "mfu_round_2": flops / secs[-1] / PEAK_BF16_FLOPS,
           "steps_a_round": fed._nb, "accs": accs, "params": fed.model.param_count,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return all(map(math.isfinite, accs)), out


def vit_rounds() -> tuple[bool, dict]:
    """``vit()`` at its defaults (patch 4, dim 64, depth 4, 4 heads) on
    config 2's data: 8 nodes, batch 64, 2 rounds with eval."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import vit
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    data = FederatedDataset.synthetic_mnist(n_train=C2["nodes"] * C2["per_node"], n_test=1024, **CIFAR_HARD)
    fed = SpmdFederation.from_dataset(vit(), data, n_nodes=C2["nodes"], batch_size=C2["batch"], vote=False, seed=3)
    secs, accs = [], []
    for _ in range(VIT_ROUNDS):
        entry, s = _sync_s(lambda: fed.run_round(eval=True))
        secs.append(s)
        accs.append(float(entry["test_acc"]))
    flops = fed.round_flops()
    return all(map(math.isfinite, accs)), {"s_per_round": secs, "accs": accs, "flops_per_round": flops,
                                            "mfu_round_2": flops / secs[-1] / PEAK_BF16_FLOPS}


def config6() -> tuple[bool, dict]:
    """Config 6 through ``examples/heterogeneous.py``: FedAvg, FedProx,
    SCAFFOLD and FedAdam on 8 MLP nodes over Dirichlet(0.3) shards, 5
    rounds each; the curves and the seconds of the whole drive."""
    from p2pfl_tpu_torch.examples import heterogeneous

    with contextlib.redirect_stdout(sys.stderr):  # stdout ends with the result lines
        curves, s = _sync_s(lambda: heterogeneous.main(C6_ARGS))
    ok = all(len(c) == 5 and all(map(math.isfinite, c)) for c in curves.values())
    return ok, {"curves": curves, "seconds": s}


def drive_cifar() -> tuple[bool, dict]:
    """The vision federation on the card (``cifar``): the CPU-vs-card pair;
    config 2 to 70 % (captured rounds), its throughput point; the captured
    span and a resumed checkpoint bit-equal; config 4's four rules under
    attack; ResNet-50 and the ViT; config 6. The path launches no hand
    kernel: every count of ``_kernels.LAUNCHES`` must read 0. The vmapped
    against the looped conv round and the profiler split of an eager round
    are ``--only trace_cifar`` (:func:`drive_trace_cifar`)."""
    from p2pfl_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    parts: dict = {}
    checks: dict = {}
    t = time.perf_counter()

    def part(name, fn):
        t0 = time.perf_counter()
        good, parts[name] = fn()
        checks[name] = good
        parts[name]["part_s"] = time.perf_counter() - t0
        log(f"[cifar] {name}: {json.dumps(parts[name])} {'OK' if good else 'FAIL'}")

    part("pair", cifar_pair)
    part("config2", config2_target)
    part("config2_throughput", lambda: (True, config2_throughput()))
    part("graph_and_resume", config2_graph_and_resume)
    part("config4", config4)
    part("resnet50", resnet50_rounds)
    part("vit", vit_rounds)
    part("config6", config6)
    hand = dict(_kernels.LAUNCHES)
    checks["no hand kernel launched"] = sum(hand.values()) == 0
    summary = {"checks": checks, "hand_kernel_launches": hand, "seconds": time.perf_counter() - t}
    ok = all(checks.values())
    log(f"[cifar] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, {"parts": parts, **summary}


def drive_trace_cifar() -> tuple[bool, dict]:
    """Config 2's round measured two ways (``--only trace_cifar``, out of
    the default run for the call's time limit): the vmapped round against
    a loop over the nodes, eager and captured (``conv_ways``), and the
    profiler split of an eager round (``round_split``)."""
    fed = _config2_fed()
    out = {"conv_vmapped_vs_looped": conv_ways(fed), "split": round_split(fed)}
    for name, row in out.items():
        log(f"[trace_cifar] {name}: {json.dumps(row)}")
    del fed
    torch.cuda.empty_cache()
    return True, out


# ---- [chunked] BASELINE config 3: 64 ResNet-50 nodes time-sharing the card ----

#: config 3 (``bench_suite.py:456-530``): 64 nodes in chunks of 16, 256
#: CIFAR-100-shaped samples a node over Dirichlet(0.5) shards, batch 32,
#: seed 3, remat, no vote; Adam over warmup-cosine 0 → 3e-3 (2 rounds of
#: 8 steps) → 1e-4 (40 rounds of 8 steps) with averaged moments; 50 %
#: within 60 rounds (``chunked_target``)
C3 = dict(nodes=64, chunk=16, per_node=256, n_test=1024, batch=32, seed=3, peak=3e-3, end=1e-4,
          warmup_rounds=2, decay_rounds=40, target=0.50, max_rounds=60, timed_rounds=3, serial_rounds=2)
C3_TASK = dict(dim=(32, 32, 3), num_classes=100, modes=2, noise=0.5, proto_scale=0.7)
#: the reduced chunked federation of the checks: 8 nodes in chunks of 4 of
#: a reduced-depth ResNet (stages (1, 1)) on 16x16x3, 64 samples a node
#: in batches of 16 (4 steps a round), remat
C3_SMALL = dict(nodes=8, chunk=4, per_node=64, batch=16, shape=(16, 16, 3), rounds=2, lr=0.05)


def _config3_fed():
    """Config 3's federation on the card."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.optimizers import adam, warmup_cosine_decay_schedule
    from p2pfl_tpu_torch.models.vision import resnet50
    from p2pfl_tpu_torch.parallel.chunked import ChunkedFederation

    spr = C3["per_node"] // C3["batch"]
    sched = warmup_cosine_decay_schedule(0.0, C3["peak"], C3["warmup_rounds"] * spr, C3["decay_rounds"] * spr,
                                         C3["end"])
    data = FederatedDataset.synthetic_mnist(n_train=C3["nodes"] * C3["per_node"], n_test=C3["n_test"], **C3_TASK)
    return ChunkedFederation.from_dataset(
        resnet50(), data, n_nodes=C3["nodes"], chunk_size=C3["chunk"], strategy="dirichlet", alpha=0.5,
        batch_size=C3["batch"], vote=False, seed=C3["seed"], remat=True, tx=adam(sched), keep_opt_state=True,
    )


def _small_chunked(device, dtype, tx):
    """The reduced chunked federation on ``device``: one init (the CPU's
    draw), one data, kept moments."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.vision import ResNet, init_resnet_params
    from p2pfl_tpu_torch.ops.tree import tree_map
    from p2pfl_tpu_torch.parallel.chunked import ChunkedFederation

    k = C3_SMALL
    module = ResNet((1, 1), dtype=dtype)
    params = init_resnet_params(module, k["shape"], 0, torch.device("cpu"))
    model = TorchModel(module, tree_map(lambda x: x.to(device), params), k["shape"])
    data = FederatedDataset.synthetic_mnist(n_train=k["nodes"] * k["per_node"], n_test=k["nodes"] * 16,
                                            dim=k["shape"], modes=2, noise=0.5, proto_scale=0.7)
    return ChunkedFederation.from_dataset(model, data, n_nodes=k["nodes"], chunk_size=k["chunk"],
                                          batch_size=k["batch"], vote=False, seed=3, remat=True, tx=tx,
                                          keep_opt_state=True, device=device)


def chunked_pair(devices=("cpu", "cuda")) -> tuple[bool, dict]:
    """One round of the reduced chunked federation in fp32 with SGD (the
    change is the gradients' sum: no sign flips of Adam's first steps) on
    the CPU against the card: the parameter change by relative L2 within
    the fp32 pair limit ``PAIR_REL_L2``."""
    from p2pfl_tpu_torch.learning.optimizers import sgd
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    changes = {}
    for dev in devices:
        fed = _small_chunked(dev, torch.float32, sgd(C3_SMALL["lr"], momentum=None))
        before = [t.clone() for t in tree_leaves(fed.params)]
        fed.run_round()
        changes[dev] = [(a - b).float().cpu() for a, b in zip(tree_leaves(fed.params), before)]
    err = _rel_l2(changes[devices[0]], changes[devices[1]])
    return err <= PAIR_REL_L2["float32"], {"change_rel_l2": err, "limit": PAIR_REL_L2["float32"],
                                          "nodes": C3_SMALL["nodes"], "chunk": C3_SMALL["chunk"]}


def chunked_paths() -> tuple[bool, dict]:
    """On the card, the reduced federation (bf16, Adam over a schedule,
    kept moments) three ways for 2 rounds: the serial path
    (``CHUNK_FUSED_REDUCE=False``, staging depth 1), the fused path eager
    (a transform marked not capturable) and the fused path as the
    captured chunk graph. Params, optimizer state and losses must be
    bit-equal across the three."""
    from p2pfl_tpu_torch.learning.learner import GradientTransformation
    from p2pfl_tpu_torch.learning.optimizers import adam, warmup_cosine_decay_schedule
    from p2pfl_tpu_torch.settings import Settings

    def tx(capturable: bool):
        t = adam(warmup_cosine_decay_schedule(0.0, 3e-3, 4, 40, 1e-4))
        return t if capturable else GradientTransformation(t.init, t.update, False, t.node_stacked)

    prior = (Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH)
    runs = {}
    try:
        for name, fused, capturable in (("serial", False, True), ("fused_eager", True, False),
                                        ("fused_graph", True, True)):
            Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = fused, (2 if fused else 1)
            fed = _small_chunked("cuda", torch.bfloat16, tx(capturable))
            losses = [fed.run_round()["train_loss"] for _ in range(C3_SMALL["rounds"])]
            runs[name] = (torch.utils._pytree.tree_leaves((fed.params, fed.opt_state)), losses,
                          bool(fed._graphs))
    finally:
        Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = prior

    def same(a, b):
        return a[1] == b[1] and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))

    out = {"fused_eager_equals_serial": same(runs["fused_eager"], runs["serial"]),
           "graph_equals_eager": same(runs["fused_graph"], runs["fused_eager"]),
           "graph_captured": runs["fused_graph"][2] and not runs["fused_eager"][2],
           "losses": {k: v[1] for k, v in runs.items()}}
    return all(v for k, v in out.items() if k != "losses"), out


def chunk_split(fed) -> dict:
    """``torch.profiler``'s split of one chunk's program run eagerly (16
    ResNet-50 nodes' epoch under remat and the fold into the
    accumulators) by kind of kernel, the card's idle share of its wall
    time, and the accumulation (``chunked._weighted_sums`` and
    ``chunked._accumulate``, the fold ``_chunk_round_acc`` runs) profiled
    apart on the same shapes."""
    from torch.profiler import ProfilerActivity, profile

    from p2pfl_tpu_torch.parallel import chunked

    perm_np = fed._make_perm_np(1)
    eff = fed.train_mask * fed.active_mask
    inputs = fed._take({0: fed._stage_chunk_inputs(0, perm_np, eff)}, 0)
    acc = chunked._zero_acc(fed.params, fed.opt_state)
    kw = dict(module=fed.module, tx=fed._tx_stacked, remat=fed.remat, in_place=True)
    chunked._chunk_round_acc(acc, fed.params, fed.opt_state, *inputs, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_s(lambda: chunked._chunk_round_acc(acc, fed.params, fed.opt_state, *inputs, **kw))
    by, total, busy, n_events, top = kernel_split(prof)
    if not n_events:
        return {"source": "torch.profiler (no device activity seen)", "wall_ms": wall * 1e3}
    # the fold of ``_chunk_round_acc`` (``_weighted_sums`` then
    # ``_accumulate``) on stacks of the trained slots' shapes
    c = fed.chunk_size
    stack, ostack = chunked._broadcast(fed.params, c), chunked._broadcast(fed.opt_state, c)
    losses = torch.zeros(c, device=inputs[3].device)

    def fold():
        contrib = chunked._weighted_sums(stack, ostack, losses, inputs[3], inputs[4])
        chunked._accumulate(acc, contrib, in_place=True)

    fold()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as fold_prof:
        fold()
        torch.cuda.synchronize()
    return {"source": "torch.profiler", "wall_ms": wall * 1e3, "kernel_ms_sum": total, "busy_ms": busy,
            "kernels": n_events, "by_kind_ms": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": top, "accumulation_ms (profiled apart)": kernel_split(fold_prof)[1],
            "idle_share": 1 - busy / (wall * 1e3)}


def config3_rounds() -> tuple[bool, dict]:
    """Config 3 at 64 nodes: a warm-up round (the chunk graph's capture),
    ``reset(seed=3)``, 3 timed rounds; MFU of model FLOPs and of executed
    FLOPs (remat's recompute, ``round_flops(hw=True)``) over the bf16
    peak; peak memory; the serial path (host-side tree adds, staging depth
    1, eager) against the overlapped one in s/round; the profiler's split
    of one chunk."""
    from p2pfl_tpu_torch.settings import Settings

    fed = _config3_fed()
    torch.cuda.reset_peak_memory_stats()
    _, warm = _sync_s(fed.run_round)
    fed.reset(seed=C3["seed"])
    entries, secs = [], []
    for _ in range(C3["timed_rounds"]):
        entry, sec = _sync_s(fed.run_round)
        entries.append(entry["train_loss"])
        secs.append(sec)
    s = statistics.median(secs)
    flops, flops_hw = fed.round_flops(), fed.round_flops(hw=True)
    peak = torch.cuda.max_memory_allocated()
    prior = (Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH)
    try:
        Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = False, 1
        fed.run_round()
        serial = [_sync_s(fed.run_round)[1] for _ in range(C3["serial_rounds"])]
    finally:
        Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = prior
    split = chunk_split(fed)
    metrics = fed.evaluate()
    out = {"nodes": fed.n, "chunk": fed.chunk_size, "steps_a_round": fed._nb, "warm_round_s": warm,
           "s_per_round": secs, "median_s": s, "train_losses": entries,
           "flops_per_round": flops, "flops_per_round_hw": flops_hw,
           "mfu": flops / s / PEAK_BF16_FLOPS, "mfu_hw": flops_hw / s / PEAK_BF16_FLOPS,
           "peak_memory_bytes": peak, "captured": bool(fed._graphs),
           "staging_split": {"serial_s_per_round": serial, "overlapped_s_per_round": s,
                             "serial_over_overlapped": statistics.median(serial) / s},
           "chunk_split": split, "test_acc": metrics["test_acc"]}
    ok = all(map(math.isfinite, entries + [metrics["test_loss"]])) and bool(fed._graphs)
    return ok, out


def drive_chunked() -> tuple[bool, dict]:
    """BASELINE config 3 through ``ChunkedFederation`` (``chunked``): the
    CPU-vs-card pair, the serial, fused and captured paths bit-equal on
    the card, then the 64 ResNet-50 nodes' rounds. No hand kernel runs:
    every count of ``_kernels.LAUNCHES`` must read 0."""
    from p2pfl_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    parts: dict = {}
    checks: dict = {}
    t = time.perf_counter()

    def part(name, fn):
        t0 = time.perf_counter()
        good, parts[name] = fn()
        checks[name] = good
        parts[name]["part_s"] = time.perf_counter() - t0
        log(f"[chunked] {name}: {json.dumps(parts[name])} {'OK' if good else 'FAIL'}")

    part("pair", chunked_pair)
    part("paths", chunked_paths)
    part("config3", config3_rounds)
    hand = dict(_kernels.LAUNCHES)
    checks["no hand kernel launched"] = sum(hand.values()) == 0
    summary = {"checks": checks, "hand_kernel_launches": hand, "seconds": time.perf_counter() - t}
    ok = all(checks.values())
    log(f"[chunked] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, {"parts": parts, **summary}


def drive_chunked_target() -> tuple[bool, dict]:
    """Config 3 to 50 % (``chunked_target``, run only when named): one
    ``run_round(eval=True)`` a round, at most 60; the curve, rounds and
    seconds to the target (from the first round, its capture included)."""
    fed = _config3_fed()
    torch.cuda.reset_peak_memory_stats()
    curve, losses = [], []
    rounds_to = seconds_to = None
    t0 = time.perf_counter()
    for r in range(C3["max_rounds"]):
        entry = fed.run_round(eval=True)
        curve.append(entry["test_acc"])
        losses.append(entry["train_loss"])
        if entry["test_acc"] >= C3["target"]:
            rounds_to, seconds_to = r + 1, time.perf_counter() - t0
            break
    out = {"target": C3["target"], "rounds_to_target": rounds_to, "seconds_to_target": seconds_to,
           "accuracy_curve": curve, "train_losses": losses, "seconds": time.perf_counter() - t0,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    ok = rounds_to is not None and all(map(math.isfinite, curve + losses))
    log(f"[chunked_target] {json.dumps(out)} {'OK' if ok else 'FAIL'}")
    return ok, out


# ---- [nameplate] BASELINE config 5 at its 32 nodes ----

#: config 5 at nameplate scale (``bench_suite.py:895-1060``): 32 nodes of 8
#: sequences at batch 1 (8 steps a round), trained 4 at a time, seed 3,
#: under ``mlp_qkv`` remat; the target run pretrains the base for 400
#: Adafactor steps of 8 sequences, then runs at most 16 rounds to a
#: next-token accuracy of 0.65 on the 15 %-shifted domain
C5 = dict(nodes=32, node_chunk=4, seq=1024, per_node=8, batch=1, n_test=32, seed=3, timed_rounds=2,
          pre_steps=400, pre_batch=8, pre_lr=3e-3, pre_train=512, pre_test=64, target=0.65, max_rounds=16,
          check_layers=2, smoke_depth=6)


def _nameplate_cfg(depth: int = 22, policy="mlp_qkv", remat: bool = True):
    from p2pfl_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=depth, ffn_hidden=5632, lora_rank=8,
        lora_mlp=True, remat=remat, remat_policy=policy if remat else None, scan_layers=True,
    )


def _nameplate_data():
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset

    return FederatedDataset.synthetic_lm(vocab_size=4096, seq_len=C5["seq"], n_train=C5["nodes"] * C5["per_node"],
                                         n_test=C5["n_test"], shift_frac=0.15)


def _nameplate_fed(model, data):
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    return SpmdLoraFederation.from_dataset(model, data, n_nodes=C5["nodes"], batch_size=C5["batch"], vote=False,
                                           seed=C5["seed"], node_chunk=C5["node_chunk"])


def lora_step_flops(cfg, tokens_per_step: int, seq: int) -> float:
    """Model FLOPs of one LoRA train step (forward and the input
    gradients; no weight gradient of the frozen base) over
    ``tokens_per_step`` tokens, as ``bench_suite.py``'s
    ``_lora_step_flops_by_depth`` counts them: 1- and 2-layer clones with
    dense attention (the attention products in the count), extrapolated
    linearly in depth. Counted by ``FlopCounterMode`` on meta tensors
    (products only: elementwise work is not counted)."""
    from dataclasses import replace

    from torch.utils.flop_counter import FlopCounterMode

    from p2pfl_tpu_torch.learning.lora import _lm_loss, split_lora
    from p2pfl_tpu_torch.models.transformer import CausalLM, init_params
    from p2pfl_tpu_torch.ops.tree import tree_map

    def f(layers: int) -> int:
        c = replace(cfg, n_layers=layers, remat=False, remat_policy=None, flash_config=None)
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                        init_params(c, seed=0, device="cpu"))
        lora, base = split_lora(meta)
        lora = tree_map(lambda t: t.requires_grad_(True), lora)
        x = torch.zeros((2, seq), dtype=torch.long, device="meta")
        with FlopCounterMode(display=False) as counter:
            loss, _ = _lm_loss(lora, base, CausalLM(c), x, x)
            loss.backward()
        return counter.get_total_flops()

    f1, f2 = f(1), f(2)
    return (f1 + (f2 - f1) * (cfg.n_layers - 1)) * (tokens_per_step / (2 * seq))


def nameplate_flops(fed, cfg) -> tuple[float, float]:
    """(model FLOPs, executed FLOPs) of a round, as ``bench_suite.py``
    counts them: ``nb`` steps of every node's tokens; executed adds the
    policy's recompute, the flash forward's two causal products
    (2·2·(T/2)·dim a token a layer)."""
    tokens = fed.n * C5["batch"] * C5["seq"]
    flops = fed._nb * lora_step_flops(cfg, tokens, C5["seq"])
    recompute = 2.0 * 2.0 * (C5["seq"] / 2) * cfg.dim * cfg.n_layers
    return flops, flops + fed._nb * recompute * tokens


def nameplate_remat_check() -> tuple[bool, dict]:
    """At a 2-layer cut on the card: one step's loss and adapter gradients
    under ``mlp_qkv`` against no remat, from one init and one batch of 4
    nodes' sequences, and no remat against itself, with each backward.
    The split backward (kernels 3 and 4: each output tile from one block)
    is deterministic, and there ``mlp_qkv`` must equal no remat bit for
    bit. Kernel 2 adds dQ tiles by bulk reductions in the order its blocks
    finish, so two of its backwards differ in the last bits: there the
    loss must be bit-equal and the gradients' gap within twice the gap of
    two runs without remat."""
    from dataclasses import replace

    from p2pfl_tpu_torch.learning.lora import _lm_loss, split_lora
    from p2pfl_tpu_torch.models.transformer import CausalLM, init_params, resolve_attention
    from p2pfl_tpu_torch.ops.autotune import default_flash_config
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_map

    depth = C5["check_layers"]
    plain_cfg = _nameplate_cfg(depth, remat=False)
    lora, base = split_lora(init_params(plain_cfg, seed=0, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    lora = tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=gen, device="cuda"), lora)
    x = torch.randint(0, 4096, (C5["node_chunk"], C5["seq"]), generator=gen, device="cuda")
    y = torch.randint(0, 4096, (C5["node_chunk"], C5["seq"]), generator=gen, device="cuda")
    flash_cfg = default_flash_config(C5["seq"], plain_cfg.head_dim)

    def step(cfg, attn):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), lora)
        loss, _ = _lm_loss(leaves, base, CausalLM(cfg, attn), x, y)
        loss.backward()
        return loss.detach(), [t.grad.float() for _, t in tree_items(leaves)]

    def equal(a, b):
        return torch.equal(a[0], b[0]) and all(torch.equal(u, v) for u, v in zip(a[1], b[1]))

    out: dict = {"layers": depth}
    ok = True
    for mode in ("split", "auto"):
        attn = resolve_attention("flash", config=replace(flash_cfg, bwd_mode=mode))
        ref, again = step(plain_cfg, attn), step(plain_cfg, attn)
        remat = step(_nameplate_cfg(depth), attn)
        row = {"repeat_bit_equal": equal(ref, again), "mlp_qkv_bit_equal": equal(ref, remat),
               "loss_bit_equal": torch.equal(ref[0], remat[0]),
               "grad_rel_l2_repeat": _rel_l2(ref[1], again[1]), "grad_rel_l2_mlp_qkv": _rel_l2(ref[1], remat[1])}
        if mode == "split":
            good = row["repeat_bit_equal"] and row["mlp_qkv_bit_equal"]
        else:
            good = row["loss_bit_equal"] and row["grad_rel_l2_mlp_qkv"] <= 2 * row["grad_rel_l2_repeat"]
        row["ok"] = good
        ok &= good
        out[mode] = row
    return ok, out


def drive_nameplate() -> tuple[bool, dict]:
    """Config 5 at 32 nodes (``nameplate``): 2048d/32h/kv4 at
    ``C5["smoke_depth"]`` of its 22 layers (the default run's time limit;
    ``nameplate_target`` runs all 22),
    seq 1024, LoRA rank 8 with ``lora_mlp``, ``remat_policy="mlp_qkv"``,
    flash attention, ``node_chunk=4``, batch 1, 8 steps a round, seed 3,
    a random base from seed 0: a warm-up round and 2 timed rounds, then
    ``evaluate``. Launch counts are zeroed before and read after, and held
    to the counts the code gives: chunks x steps x layers backward
    launches (kernel 2) and twice that forward (kernel 1: the forward and
    the policy's recompute) plus one a layer for the eval; every other
    kernel at 0. Kernels 1 and 2 against their plain versions on one
    layer's backward inputs kept from the drive; the remat check at 2
    layers; s/round, peak memory, MFU of model and executed FLOPs."""
    from p2pfl_tpu_torch.models.transformer import tiny_transformer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    t = time.perf_counter()
    cfg = _nameplate_cfg(C5["smoke_depth"])
    model = tiny_transformer(seq_len=C5["seq"], seed=0, cfg=cfg, attn="flash")
    fed = _nameplate_fed(model, _nameplate_data())
    recorded: list = []
    real_bwd = fa.flash_bwd_bhtd

    def recording_bwd(*a):
        # the drive's first layer backward, copied (nothing of the path
        # reads the copy)
        if not recorded:
            recorded.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a))
        return real_bwd(*a)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds = 1 + C5["timed_rounds"]
    fa.flash_bwd_bhtd = recording_bwd
    _kernels.reset_launches()
    try:
        first, warm = _sync_s(fed.run_round)
        timed = [_sync_s(fed.run_round) for _ in range(C5["timed_rounds"])]
        metrics = fed.evaluate()
    finally:
        fa.flash_bwd_bhtd = real_bwd
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    chunks, nb, layers = fed.n // fed.node_chunk, fed._nb, cfg.n_layers
    bwd = rounds * chunks * nb * layers
    expected = {"flash_fwd": 2 * bwd + layers, "flash_bwd_dkvq": bwd}
    secs = [s for _, s in timed]
    s = statistics.median(secs)
    flops, flops_hw = nameplate_flops(fed, cfg)
    losses = [float(first["train_loss"])] + [float(e["train_loss"]) for e, _ in timed]
    del fed, model
    torch.cuda.empty_cache()
    flash_cfg = default_flash_config(C5["seq"], cfg.head_dim)
    worst = Worst()
    q, k, v, _o, _lse, do, causal, _cfg = recorded[0]
    kernels_ok = check_flash(q, k, v, do, causal, flash_cfg.block_q, flash_cfg.block_k, worst,
                             f"nameplate layer backward inputs {list(q.shape)}")[0]
    del recorded
    remat_ok, remat = nameplate_remat_check()
    checks = {
        "launches exactly as expected": all(count == expected.get(name, 0) for name, count in launches.items()),
        "kernels 1 and 2 within their limits on the drive's layer inputs": kernels_ok,
        "mlp_qkv against no remat (2 layers)": remat_ok,
        "losses and metrics finite": all(map(math.isfinite, losses + [metrics["test_loss"]])),
    }
    ok = all(checks.values())
    summary = {"layers": layers, "nodes": C5["nodes"], "node_chunk": C5["node_chunk"], "steps_per_round": nb,
               "remat_policy": cfg.remat_policy, "warm_round_s": warm, "s_per_round": secs, "median_s": s,
               "train_losses": losses, "test_loss": metrics["test_loss"], "test_acc": metrics["test_acc"],
               "flops_per_round": flops, "flops_per_round_hw": flops_hw,
               "mfu": flops / s / PEAK_BF16_FLOPS, "mfu_hw": flops_hw / s / PEAK_BF16_FLOPS,
               "peak_memory_bytes": peak, "launches": launches, "launches_expected": expected,
               "kernel_checks_worst_share": worst.share, "kernel_checks_max_err": worst.err,
               "remat_check": remat, "checks": checks, "seconds": time.perf_counter() - t}
    log(f"[nameplate] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def pretrain_base(cfg) -> tuple[dict, list]:
    """The nameplate row's central pretrain: the full-remat twin of the
    model (``remat_policy=None``, the same tree) from seed 0, 400
    Adafactor steps (``adafactor(3e-3)``, optax's defaults) of 8 sequences
    drawn from numpy's ``default_rng(0)``, every parameter trained; the
    loss every 50 steps and the last."""
    from dataclasses import replace

    import numpy as np

    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import apply_updates, softmax_cross_entropy
    from p2pfl_tpu_torch.learning.optimizers import adafactor
    from p2pfl_tpu_torch.models.transformer import tiny_transformer
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_unflatten

    data = FederatedDataset.synthetic_lm(vocab_size=4096, seq_len=C5["seq"], n_train=C5["pre_train"],
                                         n_test=C5["pre_test"])
    pre = tiny_transformer(seq_len=C5["seq"], seed=0, cfg=replace(cfg, remat_policy=None), attn="flash")
    params = pre.params
    tx = adafactor(learning_rate=C5["pre_lr"])
    opt = tx.init(params)
    x_all = torch.from_numpy(data.x_train).cuda()
    y_all = torch.from_numpy(data.y_train).cuda()
    rng = np.random.default_rng(0)
    curve = []
    for step in range(C5["pre_steps"]):
        idx = torch.from_numpy(rng.integers(0, len(data.y_train), size=C5["pre_batch"])).cuda()
        paths = [p for p, _ in tree_items(params)]
        leaves = [t.detach().requires_grad_(True) for _, t in tree_items(params)]
        logits = pre.module(tree_unflatten(dict(zip(paths, leaves))), x_all[idx])
        loss = softmax_cross_entropy(logits, y_all[idx]).mean()
        grads = torch.autograd.grad(loss, leaves)
        del logits
        with torch.no_grad():
            updates, opt = tx.update(tree_unflatten(dict(zip(paths, grads))), opt, params)
            params = apply_updates(params, updates)
        if step % 50 == 0:
            curve.append(float(loss.detach()))
    curve.append(float(loss.detach()))
    return params, curve


def drive_nameplate_target() -> tuple[bool, dict]:
    """Config 5's full recipe (``nameplate_target``, run only when named):
    the base pretrained in the run (:func:`pretrain_base`), then the 32
    LoRA nodes under ``mlp_qkv`` on the 15 %-shifted domain, one
    ``run_round`` and ``evaluate`` a round, at most 16 rounds to a
    next-token accuracy of 0.65; the pretrain curve, the accuracy curve,
    rounds and seconds to the target (rounds only, the pretrain apart)."""
    from p2pfl_tpu_torch.models.transformer import tiny_transformer

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = _nameplate_cfg()
    params, pre_curve = pretrain_base(cfg)
    pre_s = time.perf_counter() - t
    model = tiny_transformer(seq_len=C5["seq"], seed=0, cfg=cfg, attn="flash")
    model.params = params
    fed = _nameplate_fed(model, _nameplate_data())
    del params
    acc0 = fed.evaluate()["test_acc"]
    curve, losses = [], []
    rounds_to = seconds_to = None
    t0 = time.perf_counter()
    for r in range(C5["max_rounds"]):
        losses.append(float(fed.run_round()["train_loss"]))
        curve.append(fed.evaluate()["test_acc"])
        if curve[-1] >= C5["target"]:
            rounds_to, seconds_to = r + 1, time.perf_counter() - t0
            break
    out = {"pretrain_loss_curve": pre_curve, "pretrain_s": pre_s, "random_floor_loss": math.log(4096),
           "pretrained_base_acc": acc0, "target": C5["target"], "rounds_to_target": rounds_to,
           "seconds_to_target": seconds_to, "accuracy_curve": curve, "train_losses": losses,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), "seconds": time.perf_counter() - t}
    ok = rounds_to is not None and all(map(math.isfinite, curve + losses + pre_curve))
    log(f"[nameplate_target] {json.dumps(out)} {'OK' if ok else 'FAIL'}")
    return ok, out



# ---- phase 15: the wire codecs, FedPer and secure aggregation ----


#: BASELINE config 8 (``bench_suite.py:1653-1704``): 4 MLP Nodes over
#: loopback gRPC, synthetic MNIST 2048/512, batch 64, 2 rounds of 1 epoch
C8 = dict(nodes=4, rounds=2, epochs=1, samples=2048, n_test=512, batch_size=64, topology="full")
#: a compressed run's least final accuracy may trail the uncompressed
#: run's by this much (JAX's row read them equal)
C8_ACC_GAP = 0.02
#: topk8's cross-node spread of one federation's models, max over nodes
#: of ||θ_i − θ_0|| / ||θ_0||, by tree: each node folds its own params
#: exactly and its peers' top 5 % of their round's change, so the spread
#: is a share of how far a round moves the params. It bounds divergence:
#: nodes that keep their own training (phase ``compress_control``'s
#: ``wrong_base`` codec) read above it. It cannot see a codec that drops
#: the peers' deltas (the ``dropped`` codec reads as the sound runs do):
#: the bit-equality checks of one update through the plane hold that.
#: Read on an H100 (sound / ``dropped`` / ``wrong_base``): MLP 0.033-0.049
#: / 0.032 / 0.100, LoRA 0.078 / 0.090 / 0.268; each limit sits between
#: the sound runs and ``wrong_base``
LOSSY_REL_SPREAD = {"mlp": 0.075, "lora": 0.15}
#: a secure-aggregation round's aggregate against the FedAvg of the
#: recorded unmasked contributions, max abs (the JAX package's
#: ``test_masks_cancel_in_weighted_fedavg`` bound; the masks are
#: SECAGG_MASK_STD = 100 and cancel to fp32 rounding of their sum)
SECAGG_ATOL = 1e-3
#: BASELINE config 9 (``bench_suite.py:1974-2038``): FedPer's mean local
#: accuracy must exceed one global FedAvg model's by at least this
C9_MIN_GAIN = 0.30


def _lossy_logs():
    """A handler that keeps the ICI plane's failed-transfer logs."""
    import logging

    failures: list = []

    class _Failed(logging.Handler):
        def emit(self, record):
            if "ICI shard transfer" in record.getMessage():
                failures.append(record.getMessage())

    return _Failed(), failures


@contextlib.contextmanager
def _ici_probes():
    """Record the ICI plane's fallback reasons and the bytes every codec
    transfer hands to the exchange (the counts of ``ici_stats`` read
    beside them)."""
    from p2pfl_tpu_torch.communication import ici as ici_mod

    rec = {"reasons": [], "transfer_bytes": 0, "transfers": 0}
    real_fb, real_tb = ici_mod._fallback, ici_mod.transfer_buffers

    def fallback(src, nei, reason):
        rec["reasons"].append(reason)
        real_fb(src, nei, reason)

    def transfer(srcs, dst):
        rec["transfer_bytes"] += sum(t.numel() * t.element_size() for t in srcs)
        rec["transfers"] += 1
        return real_tb(srcs, dst)

    ici_mod._fallback, ici_mod.transfer_buffers = fallback, transfer
    try:
        yield rec
    finally:
        ici_mod._fallback, ici_mod.transfer_buffers = real_fb, real_tb


def _rel_spread(trees: list) -> float:
    """max over nodes of ||tree_i − tree_0|| / ||tree_0|| (fp64)."""
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    flat = [torch.cat([x.double().reshape(-1).cpu() for x in tree_leaves(t)]) for t in trees]
    return max(float((f - flat[0]).norm() / flat[0].norm()) for f in flat[1:])


@contextlib.contextmanager
def _weights_sends():
    """Count the gRPC weight messages by kind: ``init`` (the initial model),
    ``own`` (a node's own contribution) and ``aggregate`` (a model of two or
    more contributors). A peer that has not yet reported a model is sent it
    again every ``GOSSIP_MODELS_PERIOD``, so beyond 12 own messages a round
    the count reads how long receivers take to report."""
    from p2pfl_tpu_torch.communication import grpc_transport as gt

    kinds = {"init": 0, "own": 0, "aggregate": 0}
    real_enc, real_stream = gt._enc_weights, gt.GrpcProtocol._try_stream_send

    def note(env):
        kind = "init" if env.cmd == "init_model" else "own" if len(env.update.contributors) == 1 else "aggregate"
        kinds[kind] += 1

    def enc(env):
        note(env)
        return real_enc(env)

    def stream(self, channel, nei, env):
        handled = real_stream(self, channel, nei, env)
        if handled is not None:
            note(env)
        return handled

    gt._enc_weights, gt.GrpcProtocol._try_stream_send = enc, stream
    try:
        yield kinds
    finally:
        gt._enc_weights, gt.GrpcProtocol._try_stream_send = real_enc, real_stream


def compress_config8(device: str = "cuda") -> tuple[bool, dict]:
    """(a) BASELINE config 8 at its stated size under ``none``, ``int8`` and
    ``topk8``: weight-plane egress (``GrpcProtocol.wire_stats``), messages
    (by kind, :func:`_weights_sends`), least final accuracy, s/round."""
    from p2pfl_tpu_torch.examples import mnist
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.settings import Settings, set_test_settings

    try:
        import grpc  # noqa: F401 — part (a) is a gRPC federation
    except ImportError:
        log("[compress] (a) config 8 needs grpc, which is not installed FAIL")
        return False, {}
    rows = {}
    for mode in ("none", "int8", "topk8"):
        set_test_settings()
        logger.set_level("WARNING")
        Settings.WIRE_COMPRESSION = mode
        try:
            with _weights_sends() as kinds:
                out = mnist.run(protocol="grpc", device=device, **C8)
        finally:
            Settings.WIRE_COMPRESSION = "none"
        ws = out["wire_stats"]
        rows[mode] = dict(
            weights_MB=sum(w["weights_bytes"] for w in ws) / 1e6, weights_msgs=sum(w["weights_msgs"] for w in ws),
            msgs_by_kind=dict(kinds),
            min_final_acc=min(m["test_acc"] for m in out["metrics"]),
            test_loss=[m["test_loss"] for m in out["metrics"]], s_per_round=out["round_s"],
            elapsed_s=out["elapsed_s"],
        )
    none = rows["none"]
    checks = {
        "int8 egress below none's": rows["int8"]["weights_MB"] < none["weights_MB"],
        "topk8 egress below none's": rows["topk8"]["weights_MB"] < none["weights_MB"],
        f"compressed least accuracy within {C8_ACC_GAP} of none's": all(
            rows[m]["min_final_acc"] >= none["min_final_acc"] - C8_ACC_GAP for m in ("int8", "topk8")),
        "losses finite": all(math.isfinite(x) for r in rows.values() for x in r["test_loss"]),
    }
    ok = all(checks.values())
    summary = {"rows": rows, "egress_ratio_int8": none["weights_MB"] / rows["int8"]["weights_MB"],
               "egress_ratio_topk8": none["weights_MB"] / rows["topk8"]["weights_MB"], "checks": checks}
    log(f"[compress] (a) config 8: {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def _codec_trees(device: str) -> tuple[dict, dict, dict]:
    """An MLP sender, anchor and receiver template plus two raw
    passthrough leaves (bf16 and int32), from seeds."""
    from p2pfl_tpu_torch.models.vision import mlp

    def tree(seed):
        t = dict(mlp(seed=seed, device=device).params)
        g = torch.Generator(device=device).manual_seed(seed)
        t["extra"] = {"bf16": torch.randn((3, 5, 7), generator=g, device=device).to(torch.bfloat16),
                      "steps": torch.arange(7, dtype=torch.int32, device=device) + seed}
        return t

    return tree(0), tree(1), tree(2)


def _first_round_residual(mode: str, tree: dict, anchor: dict):
    """Under topk8, the error-feedback residual an earlier round's encode
    of ``tree`` leaves behind (the device producer); None under int8."""
    from p2pfl_tpu_torch.learning import weights as tw
    from p2pfl_tpu_torch.settings import Settings

    if mode != "topk8":
        return None
    residual: dict = {}
    prev = Settings.WIRE_COMPRESSION_DEVICE
    Settings.WIRE_COMPRESSION_DEVICE = True
    try:
        tw.encode_params(tree, compression=mode, anchor=anchor, anchor_tag="0:9", residual=residual)
    finally:
        Settings.WIRE_COMPRESSION_DEVICE = prev
    return residual


def _perturbed(tree, seed: int, scale: float = 1e-3):
    """A copy of ``tree`` with a seeded perturbation on every other float
    leaf; the rest stay equal (their deltas are all ties at zero)."""
    from p2pfl_tpu_torch.learning.weights import named_leaves
    from p2pfl_tpu_torch.ops.tree import tree_unflatten

    out = {}
    for i, (key, leaf) in enumerate(named_leaves(tree)[1]):
        leaf = leaf.detach().clone()
        if i % 2 == 0 and leaf.is_floating_point():
            g = torch.Generator(device=leaf.device).manual_seed(seed * 1000 + i)
            leaf += scale * torch.randn(leaf.shape, generator=g, device=leaf.device, dtype=leaf.dtype)
        out[key] = leaf
    return tree_unflatten(out)


def codec_update_check(mode: str, params: dict, anchor: dict, template: dict, residual=None,
                       device: str = "cuda") -> tuple[bool, dict, list]:
    """One update through ``ici._move_codec`` between two disjoint slots
    against ``encode_params`` → ``decode_params`` of the same update on
    the same device (``ici.move_codec_against_bytes``), bit for bit, with
    the error read as values beside; returns the transfer's sources (the
    codec tree kernel 9 moved)."""
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.learning import weights as tw
    from p2pfl_tpu_torch.parallel.ici_plane import slice_info_of
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
    from p2pfl_tpu_torch.settings import Settings

    slices = node_slices(submesh_federation_mesh(2, devices=[device] * 2))
    src_info, dst_info = slice_info_of(params, slices[0]), slice_info_of(template, slices[1])

    class _Receiver:
        @staticmethod
        def wire_anchor():
            return anchor, "1:0"

    prev = Settings.WIRE_COMPRESSION_DEVICE
    Settings.WIRE_COMPRESSION_DEVICE = True  # the producer the plane runs
    try:
        update = tw.ModelUpdate(params, ["a"], 10, anchor=anchor, anchor_tag="1:0", ef_residual=residual)
        got, want, moved, srcs = ici_mod.move_codec_against_bytes(update, template, src_info, dst_info,
                                                                  _Receiver(), mode)
    finally:
        Settings.WIRE_COMPRESSION_DEVICE = prev
    got, want = dict(tw.named_leaves(got)[1]), dict(tw.named_leaves(want)[1])
    equal = sorted(got) == sorted(want) and all(bits_equal(got[k], want[k]) for k in want)
    err = max((got[k].double() - want[k].double()).abs().max().item() for k in want)
    n_bytes = sum(t.numel() * t.element_size() for t in srcs)
    row = dict(equal=equal, max_abs_err=err, moved=moved, transfer_bytes=n_bytes, buffers=len(srcs),
               dtypes=sorted({str(t.dtype) for t in srcs}), residual=residual is not None,
               byte_residues_mod16=sorted({t.numel() * t.element_size() % 16 for t in srcs} - {0}))
    return equal and moved == n_bytes, row, srcs


def compress_ici(device: str = "cuda") -> tuple[bool, dict]:
    """(b) The ICI plane under topk8: the gossip phase's 4 MLP Nodes on
    disjoint slots; one update through ``_move_codec`` against the byte
    path; kernel 9 against its plain version on the codec tree."""
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.examples import mnist
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain
    from p2pfl_tpu_torch.settings import Settings, set_test_settings

    set_test_settings()
    logger.set_level("WARNING")
    Settings.WIRE_COMPRESSION = "topk8"
    handler, failures = _lossy_logs()
    logger._logger.addHandler(handler)
    ici_mod.reset_ici_stats()
    _kernels.reset_launches()
    try:
        with _ici_probes() as rec:
            out = mnist.run(nodes=4, weights_plane="ici", **{**GOSSIP_KW, "device": device})
        if device == "cuda":
            torch.cuda.synchronize()
        launches = _kernels.LAUNCHES["ici_exchange"]
        stats = ici_mod.ici_stats()
    finally:
        Settings.WIRE_COMPRESSION = "none"
        logger._logger.removeHandler(handler)
    params, anchor, template = _codec_trees(device)
    updates = {mode: codec_update_check(mode, params, anchor, template, _first_round_residual(mode, template, anchor),
                                        device) for mode in ("topk8", "int8")}
    checks = {
        "kernel 9 carried the codec payloads": device != "cuda" or launches > 0,
        "shard_sends > 0": stats["shard_sends"] > 0,
        "fallbacks only anchor_round_mismatch": set(rec["reasons"]) <= {"anchor_round_mismatch"},
        "bytes_moved equals the transfer trees' bytes": stats["bytes_moved"] == rec["transfer_bytes"] > 0,
        "no failed transfer": not failures,
        "no alignment fix-up": stats["align_violations"] == 0,
        "losses finite": all(math.isfinite(m["test_loss"]) for m in out["metrics"]),
        f"models within the lossy spread ({LOSSY_REL_SPREAD['mlp']})": (
            _rel_spread(out["params"]) <= LOSSY_REL_SPREAD["mlp"]),
        **{f"_move_codec {m} equals the byte path bit for bit": u[0] for m, u in updates.items()},
        "the codec tree holds buffers of a byte length not a multiple of 16": bool(
            updates["topk8"][1]["byte_residues_mod16"]),
    }
    row = None
    if device == "cuda":
        srcs = updates["topk8"][2]
        dsts, refs = [torch.empty_like(s) for s in srcs], [torch.empty_like(s) for s in srcs]
        for d in dsts + refs:
            d.zero_()
        _kernels.ici_exchange(srcs, dsts)
        exchange_plain(srcs, refs)
        torch.cuda.synchronize()
        checks["kernel 9 bit-equal to its plain version on the codec tree"] = all(
            bits_equal(d, r) and bits_equal(d, s) for d, r, s in zip(dsts, refs, srcs))
        # as values and as bytes (int8 q, int32 idx, fp32 scales, raw leaves)
        err = max(max((d.double() - r.double()).nan_to_num().abs().max().item(),
                      (d.reshape(-1).view(torch.uint8).int() - r.reshape(-1).view(torch.uint8).int()).abs().max().item())
                  for d, r in zip(dsts, refs))
        n_bytes = sum(s.numel() * s.element_size() for s in srcs)
        bms, by = bound(2 * n_bytes, 0)
        row = dict(leaves=len(srcs), bytes=n_bytes, max_abs_err=err,
                   ms=time_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
                   plain_ms=time_ms(lambda: exchange_plain(srcs, refs)), bound_ms=bms, bound_by=by,
                   library_ms=time_ms(lambda: torch._foreach_copy_(refs, srcs)))
        row.update(device_times(lambda: _kernels.ici_exchange(srcs, dsts),
                                lambda: torch._foreach_copy_(refs, srcs)))
    ok = all(checks.values())
    summary = {"nodes": 4, "rounds": GOSSIP_KW["rounds"], "samples": GOSSIP_KW["samples"], "ici_stats": stats,
               "launches_ici_exchange": launches, "fallback_reasons": sorted(set(rec["reasons"])),
               "fallbacks": len(rec["reasons"]), "transfer_bytes": rec["transfer_bytes"],
               "s_per_round": out["round_s"], "test_acc": [m["test_acc"] for m in out["metrics"]],
               "rel_spread": _rel_spread(out["params"]), "updates": {m: u[1] for m, u in updates.items()},
               "kernel9_codec_tree": row, "failed_transfer_logs": failures[:3], "checks": checks}
    log(f"[compress] (b) ICI plane under topk8: {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def compress_full_width(device: str = "cuda", depth: int = 22) -> tuple[bool, dict]:
    """(c) The codec on config 5's whole tree as fp32 master params: the
    anchor is the tree, the params the anchor plus a seeded perturbation
    (every fourth leaf left unchanged: all ties), a residual on half the
    perturbed delta-coded leaves. ``encode_device`` under topk8 and int8
    and ``decode_tk8_device``, timed; two layers' leaves encoded again on
    the CPU from copies taken before, and the card's idx, q, scale,
    residual and frame held bit for bit against them."""
    from p2pfl_tpu_torch import native
    from p2pfl_tpu_torch.learning import weights as tw
    from p2pfl_tpu_torch.models.transformer import init_params
    from p2pfl_tpu_torch.ops import compression as comp
    from p2pfl_tpu_torch.ops.tree import tree_items
    from p2pfl_tpu_torch.settings import Settings

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg = _config5(depth)
    anchor = dict(tree_items(init_params(cfg, seed=0, device=device)))
    keys = sorted(anchor)
    gen = torch.Generator(device=device).manual_seed(12)
    params = {k: anchor[k] if i % 4 == 0 else anchor[k] + 1e-3 * torch.randn(
        anchor[k].shape, generator=gen, device=device) for i, k in enumerate(keys)}
    plan = comp.build_topk_plan(params, anchor, Settings.TOPK_FRACTION)
    residual = {k: 1e-4 * torch.randn(anchor[k].numel(), generator=gen, device=device)
                for i, k in enumerate(sorted(plan)) if i % 2 and params[k] is not anchor[k]}
    sub = [k for k in keys if k.startswith(("layer_0/", "layer_1/"))]
    cpu = {k: params[k].to("cpu", copy=True) for k in sub}
    cpu_anchor = {k: anchor[k].to("cpu", copy=True) for k in sub}
    cpu_res = {k: residual[k].to("cpu", copy=True) for k in sub if k in residual}
    host_res = {k: v.clone() for k, v in cpu_res.items()}
    n_params = sum(v.numel() for v in params.values())
    param_bytes = 4 * n_params
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    plans, d2h = comp.encode_device(params, anchor, plan, residual)
    sync()
    tk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plans_i8, d2h_i8 = comp.encode_device(params, None, {}, None)
    sync()
    i8_s = time.perf_counter() - t0
    items = []
    for entry, bufs in plans:
        if entry.get("enc") == "tk8":
            idx = np.frombuffer(bufs[0], np.uint32)
            vals = native.dequantize(np.frombuffer(bufs[1], np.int8), entry["scale"])
            items.append((entry["k"], anchor[entry["k"]], idx, vals, tuple(entry["shape"]), torch.float32))
    sync()
    t0 = time.perf_counter()
    decoded = comp.decode_tk8_device(items)
    sync()
    dec_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")

    # the CPU's run of the same producer on two layers' leaves
    sub_plan = {k: plan[k] for k in sub if k in plan}
    cpu_plans, _ = comp.encode_device(cpu, cpu_anchor, sub_plan, cpu_res)
    card_sub = [(e, b) for e, b in plans if e["k"] in set(sub)]
    entries_equal = [(e1, [bytes(x) for x in b1]) == (e2, [bytes(x) for x in b2])
                     for (e1, b1), (e2, b2) in zip(card_sub, cpu_plans)]
    residual_equal = all(bits_equal(residual[k].cpu(), cpu_res[k]) for k in cpu_res)
    frame_equal = tw._frame(card_sub, "t") == tw._frame(cpu_plans, "t")
    cpu_items = [(k, cpu_anchor[k], i, v, s, d) for k, _a, i, v, s, d in items if k in set(sub)]
    cpu_dec = comp.decode_tk8_device(cpu_items)
    decode_equal = all(bits_equal(decoded[k].cpu(), cpu_dec[k]) for k in cpu_dec)
    i8_card = [(e, [bytes(x) for x in b]) for e, b in plans_i8 if e["k"] in set(sub)]
    i8_cpu = [(e, [bytes(x) for x in b]) for e, b in comp.encode_device(cpu, None, {}, None)[0]]
    # the host producer (numpy, the native quantize) on the same leaves:
    # one layout, but its own choice among tied magnitudes and its
    # reciprocal-multiply quantization, so its bytes may differ at ties
    host_plans, _ = tw._encode_host(cpu, "topk8", cpu_anchor, sub_plan, host_res)
    host_differs = sum(({**e1, "n": 0}, [bytes(x) for x in b1]) != ({**e2, "n": 0}, [bytes(x) for x in b2])
                       for (e1, b1), (e2, b2) in zip(host_plans, cpu_plans))
    host_gap = max(float((tw.decode_params(tw._frame(host_plans, "t"), anchor=cpu_anchor, anchor_tag="t")[k]
                          - cpu_dec[k]).abs().max()) for k in cpu_dec)
    checks = {
        "topk8 idx/q/scale of two layers equal to the CPU's": all(entries_equal) and len(entries_equal) == len(sub),
        "residual equal to the CPU's": residual_equal and len(cpu_res) > 0,
        "frame byte-identical to the CPU's": frame_equal,
        "tk8 decode equal to the CPU's": decode_equal,
        "int8 of two layers equal to the CPU's": i8_card == i8_cpu,
        "ties present (leaves left unchanged)": any(params[k] is anchor[k] for k in sub_plan),
    }
    del params, anchor, residual, decoded, plans, plans_i8
    if device == "cuda":
        torch.cuda.empty_cache()
    ok = all(checks.values())
    summary = {"layers": depth, "params": n_params, "param_GB": param_bytes / 1e9,
               "topk8_s": tk_s, "topk8_GBps": param_bytes / 1e9 / tk_s, "topk8_d2h_MB": d2h / 1e6,
               "int8_s": i8_s, "int8_GBps": param_bytes / 1e9 / i8_s, "int8_d2h_MB": d2h_i8 / 1e6,
               "decode_tk8_s": dec_s, "decode_leaves": len(items), "peak_mem_gb": peak,
               "host_producer_entries_differing": host_differs, "host_vs_device_decoded_max_gap": host_gap,
               "checks": checks}
    log(f"[compress] (c) config 5's tree at full width: {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def compress_lora(depth: int = COMPRESS_LORA_DEPTH, rounds: int = 2, device: str = "cuda") -> tuple[bool, dict]:
    """(d) ``drive_node_lora``'s config-5 federation (4 Nodes, seq 1024,
    batch 2) under topk8 on the ICI plane, each node on its own slot of
    the card; launches of kernels 1, 2 and 9 zeroed before and read after.
    The nodes' adapters must end within ``LOSSY_REL_SPREAD["lora"]`` of each other
    and every base bit-unchanged."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.lora import LoRALearner
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.models.transformer import tiny_transformer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
    from p2pfl_tpu_torch.settings import Settings
    from p2pfl_tpu_torch.simulation import Simulation

    _node_lora_settings()
    Settings.WIRE_COMPRESSION, Settings.WEIGHTS_PLANE = "topk8", "ici"
    k = NODE_LORA
    n = k["nodes"]
    data = FederatedDataset.synthetic_lm(
        vocab_size=4096, seq_len=k["seq"], n_train=k["n_train"], n_test=k["n_test"], shift_frac=0.15
    )
    model = tiny_transformer(seq_len=k["seq"], seed=0, cfg=_config5(depth), attn="flash", device=device)
    dev = tree_leaves(model.params)[0].device
    slices = node_slices(submesh_federation_mesh(n, devices=[dev] * n))

    def learner(i, shard):
        lr = LoRALearner(model, shard, batch_size=k["batch"], learning_rate=k["lr"], seed=i)
        lr.mesh = slices[i]  # its own slot: kernel 9 moves the codec payloads
        return lr

    handler, failures = _lossy_logs()
    logger._logger.addHandler(handler)
    sim = Simulation(n, learner, data, topology="full")
    bases = [[x.cpu() for x in tree_leaves(node.learner.base)] for node in sim.nodes]
    try:
        with _ici_probes() as rec:
            sim.start()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            sim.learn(rounds=rounds, epochs=1, timeout=900)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(_kernels.LAUNCHES)
        adapters = [n_.learner.get_parameters() for n_ in sim.nodes]
        spread = _rel_spread(adapters)
        # one adapter update with a residual through the plane against the
        # byte path, on the drive's own trees and anchor
        anchor = sim.nodes[0].learner.wire_anchor()[0]
        update_ok, update_row, _ = codec_update_check(
            "topk8", _perturbed(adapters[0], seed=5), anchor, adapters[1],
            _first_round_residual("topk8", _perturbed(adapters[0], seed=6), anchor), dev.type)
        metrics = sim.evaluate()
        base_ok = all(all(torch.equal(a, b.cpu()) for a, b in zip(before, tree_leaves(node.learner.base)))
                      for before, node in zip(bases, sim.nodes))
    finally:
        sim.stop()
        logger._logger.removeHandler(handler)
        Settings.WIRE_COMPRESSION, Settings.WEIGHTS_PLANE = "none", "bytes"
    del sim, model, bases, adapters, anchor
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    on_card = dev.type == "cuda"
    checks = {
        "kernels 1 and 2 launched": not on_card or (launches["flash_fwd"] > 0 and launches["flash_bwd_dkvq"] > 0),
        "kernel 9 carried the codec payloads": not on_card or launches["ici_exchange"] > 0,
        "codec payloads moved between slots": rec["transfer_bytes"] > 0,
        "fallbacks only anchor_round_mismatch": set(rec["reasons"]) <= {"anchor_round_mismatch"},
        "no failed transfer": not failures,
        f"adapters within the lossy spread ({LOSSY_REL_SPREAD['lora']})": spread <= LOSSY_REL_SPREAD["lora"],
        "an adapter update through _move_codec equals the byte path bit for bit": update_ok,
        "base bit-unchanged": base_ok,
        "metrics finite": all(math.isfinite(m["test_loss"]) for m in metrics.values()),
    }
    ok = all(checks.values())
    summary = {"layers": depth, "nodes": n, "seq": k["seq"], "rounds": rounds, "s_per_round": seconds / rounds,
               "launches": {x: v for x, v in launches.items() if v}, "adapter_rel_spread": spread,
               "update": update_row,
               "fallbacks": len(rec["reasons"]), "transfer_bytes": rec["transfer_bytes"],
               "test_loss": [m["test_loss"] for m in metrics.values()], "checks": checks}
    log(f"[compress] (d) LoRA Nodes under topk8 on the ICI plane: {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, {**summary, "launches": launches}


def _fedavg_f64(contribs: list) -> dict:
    """Σ w·p / Σ w of recorded ``(params {path: fp64}, w)``, in fp64."""
    total = sum(w for _p, w in contribs)
    return {k: sum(w * p[k] for p, w in contribs) / total for k in contribs[0][0]}


def _secagg_federation(device: str, rounds: int, crash: bool) -> dict:
    """A 4-node secure-aggregation federation (memory transport): through
    ``examples/secure_mnist.run``, or, with ``crash``, the same nodes with
    node 3 hard-crashed as it enters round 0's TrainStage (``CrashSpec``)
    and the survivors run to the end. Records every unmasked
    contribution and its masked result (``secagg.mask_update``, timed)
    and every node's aggregate as it enters RoundFinishedStage."""
    from p2pfl_tpu_torch.communication.faults import CrashSpec, FaultPlan, install_fault_plan
    from p2pfl_tpu_torch.examples import secure_mnist
    from p2pfl_tpu_torch.learning import secagg
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
    from p2pfl_tpu_torch.ops.tree import tree_items
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
    from p2pfl_tpu_torch.settings import Settings, set_test_settings
    from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

    set_test_settings()
    logger.set_level("WARNING")
    rec = {"contrib": {}, "masked_std": [], "mask_s": [], "aggs": {}}
    real_mask = secagg.mask_update

    def f64(tree):
        return {k: v.detach().double().cpu() for k, v in tree_items(tree)}

    def mask(update, my_addr, train_set, priv, pubs, experiment, round_no, **kw):
        # host clock, no device synchronize: another node may be capturing
        # its train step as a CUDA graph, and a device-wide synchronize
        # during a capture fails it (the masks' copies to the card wait for
        # their own stream)
        t0 = time.perf_counter()
        out = real_mask(update, my_addr, train_set, priv, pubs, experiment, round_no, **kw)
        rec["mask_s"].append(time.perf_counter() - t0)
        raw = f64(update.params)
        rec["contrib"][(round_no, my_addr)] = (raw, update.num_samples)
        rec["masked_std"].append(min(float((v - raw[k]).std()) for k, v in f64(out.params).items()))
        return out

    def record(node, stage):
        if stage == "RoundFinishedStage":
            rec["aggs"][(node.state.round, node.addr)] = f64(node.learner.get_parameters())

    def on_start(fleet):
        for node in fleet:
            node.stage_hooks.append(record)

    secagg.mask_update = mask
    try:
        if not crash:
            out = secure_mnist.run(mode="secagg", nodes=4, rounds=rounds, device=device, on_start=on_start)
            rec["test_acc"] = [m["test_acc"] for m in out["metrics"]]
            rec["survivors"] = out["addrs"]
        else:
            Settings.SECURE_AGGREGATION = True
            data = FederatedDataset.synthetic_mnist(n_train=4096, n_test=512)
            slices = node_slices(submesh_federation_mesh(4, devices=[device] * 4))
            fleet = [Node(learner=TorchLearner(mlp(seed=i, device=device), data.partition(i, 4), batch_size=64,
                                               seed=i, mesh=slices[i])) for i in range(4)]
            try:
                for node in fleet:
                    node.start()
                for node in fleet:
                    full_connection(node, fleet)
                wait_convergence(fleet, 3, only_direct=True, wait=30)
                install_fault_plan(fleet, FaultPlan(seed=0, crashes={fleet[3].addr: CrashSpec("TrainStage", 0)}))
                on_start(fleet)
                fleet[0].set_start_learning(rounds=rounds, epochs=1)
                wait_to_finish(fleet[:3], timeout=300)
                rec["test_acc"] = [node.learner.evaluate()["test_acc"] for node in fleet[:3]]
                rec["survivors"] = [node.addr for node in fleet[:3]]
            finally:
                for node in fleet:
                    node.stop()
                stop_leaked_nodes()
                Settings.SECURE_AGGREGATION = False
    finally:
        secagg.mask_update = real_mask
    return rec


def compress_secagg(device: str = "cuda") -> tuple[bool, dict]:
    """(e) Secure aggregation: ``examples/secure_mnist --mode secagg`` (4
    Nodes, memory transport, 2 rounds): each round's aggregate on every
    node against the FedAvg of the recorded unmasked contributions within
    ``SECAGG_ATOL``; then one round with node 3 crashed on entering it:
    the survivors' aggregate against the FedAvg of their own
    contributions. Logs the mask seconds a node a round."""
    runs = {"clean": _secagg_federation(device, rounds=2, crash=False),
            "crash": _secagg_federation(device, rounds=1, crash=True)}
    checks, gaps = {}, {}
    for name, rec in runs.items():
        rounds = sorted({r for r, _a in rec["aggs"]})
        worst = 0.0
        for r in rounds:
            want = _fedavg_f64([c for (rr, _a), c in rec["contrib"].items() if rr == r])
            for (rr, addr), got in rec["aggs"].items():
                if rr == r and addr in rec["survivors"]:
                    worst = max(worst, max(float((got[k] - want[k]).abs().max()) for k in want))
        gaps[name] = worst
        checks[f"{name}: every round's aggregate within {SECAGG_ATOL} of the unmasked FedAvg"] = (
            bool(rounds) and worst <= SECAGG_ATOL
            and all((r, a) in rec["aggs"] for r in rounds for a in rec["survivors"]))
        checks[f"{name}: masked contributions far from the raw ones"] = min(rec["masked_std"]) > 1.0
    checks["crash: three contributions, the survivors'"] = len(runs["crash"]["contrib"]) == 3
    ok = all(checks.values())
    summary = {"aggregate_max_gap": gaps, "mask_s_per_node_round": runs["clean"]["mask_s"],
               "crash_mask_s": runs["crash"]["mask_s"],
               "test_acc": {k: r["test_acc"] for k, r in runs.items()},
               "masked_min_std": {k: min(r["masked_std"]) for k, r in runs.items()}, "checks": checks}
    log(f"[compress] (e) secure aggregation: {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def compress_config9(device: str = "cuda") -> tuple[bool, dict]:
    """(f) BASELINE config 9 at its stated size: 4 Nodes on
    ``synthetic_mnist(4096, 1024, modes=4, noise=0.6, proto_scale=0.6)``,
    node i's labels permuted by ``default_rng(100 + i)``, 5 rounds of 2
    epochs, one global FedAvg model against FedPer (``personal=("Dense_2",)``):
    mean local accuracy, bodies equal across nodes, heads apart."""
    from p2pfl_tpu_torch.communication.memory import MemoryRegistry
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.learning.personalization import PersonalizedLearner
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.ops.tree import tree_items
    from p2pfl_tpu_torch.settings import Settings, set_test_settings
    from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

    rows, trees = {}, {}
    for label in ("fedavg_global", "fedper_personal"):
        set_test_settings()
        logger.set_level("WARNING")
        Settings.TRAIN_SET_SIZE = 4
        MemoryRegistry.reset()
        full = FederatedDataset.synthetic_mnist(n_train=4096, n_test=1024, modes=4, noise=0.6, proto_scale=0.6)
        fleet = []
        try:
            for i in range(4):
                shard = full.partition(i, 4)
                perm = np.random.default_rng(100 + i).permutation(shard.num_classes)
                shard.y_train, shard.y_test = perm[shard.y_train], perm[shard.y_test]
                if label == "fedper_personal":
                    lr = PersonalizedLearner(mlp(seed=i, device=device), shard, batch_size=64, personal=("Dense_2",))
                else:
                    lr = TorchLearner(mlp(seed=i, device=device), shard, batch_size=64)
                fleet.append(Node(learner=lr))
                fleet[-1].start()
            for node in fleet:
                full_connection(node, fleet)
            wait_convergence(fleet, 3, only_direct=True, wait=30)
            t0 = time.monotonic()
            fleet[0].set_start_learning(rounds=5, epochs=2)
            wait_to_finish(fleet, timeout=600)
            elapsed = time.monotonic() - t0
            accs = [float(node.learner.evaluate()["test_acc"]) for node in fleet]
            trees[label] = [{k: v.float().cpu() for k, v in tree_items(node.learner.get_parameters())}
                            for node in fleet]
        finally:
            for node in fleet:
                node.stop()
        rows[label] = {"mean_local_acc": float(np.mean(accs)), "per_node": accs, "wall_s": elapsed}
    per = trees["fedper_personal"]
    body = max(float((t[k] - per[0][k]).abs().max()) for t in per[1:] for k in t if not k.startswith("Dense_2"))
    head = min(float((t[k] - per[0][k]).abs().max()) for t in per[1:] for k in t if k.startswith("Dense_2"))
    gain = rows["fedper_personal"]["mean_local_acc"] - rows["fedavg_global"]["mean_local_acc"]
    checks = {
        f"FedPer's mean local accuracy >= global's + {C9_MIN_GAIN}": gain >= C9_MIN_GAIN,
        "bodies equal across nodes (1e-4)": body <= 1e-4,
        "heads differ across nodes": head > 1e-3,
    }
    ok = all(checks.values())
    summary = {"rows": rows, "gain": gain, "body_max_gap": body, "head_min_gap": head, "checks": checks}
    log(f"[compress] (f) config 9: {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def drive_compress() -> tuple[bool, dict]:
    """Phase ``compress``: parts (a)-(f), each failing the phase on its own
    (none is caught and skipped)."""
    from p2pfl_tpu_torch.settings import set_test_settings

    parts = {}
    ok = True
    for name, fn in (("config8", compress_config8), ("ici", compress_ici), ("full_width", compress_full_width),
                     ("lora", compress_lora), ("secagg", compress_secagg), ("config9", compress_config9)):
        t0 = time.perf_counter()
        good, parts[name] = fn()
        parts[name]["seconds"] = time.perf_counter() - t0
        ok &= good
        set_test_settings()
    log(f"[compress] seconds per part: {json.dumps({k: round(v['seconds'], 1) for k, v in parts.items()})}")
    return ok, parts


#: the broken ICI codecs of phase ``compress_control``: ``dropped`` zeroes
#: the tk8 values a receiver decodes (each delta-coded leaf lands as its
#: anchor: the peers' deltas dropped); ``wrong_base`` decodes them onto the
#: receiver's own current params in place of its anchor
BROKEN_CODECS = ("dropped", "wrong_base")


@contextlib.contextmanager
def _broken_codec(kind: str):
    """Every ICI receiver decodes through the broken codec ``kind``
    (:data:`BROKEN_CODECS`)."""
    from p2pfl_tpu_torch.ops import compression as comp

    real = comp.decode_shard_device

    def broken(bufs, tk_spec, dense_spec, anchor_named, template_named):
        if kind == "dropped":
            bufs = {k: torch.zeros_like(v) if k == "q" else v for k, v in bufs.items()}
        else:
            anchor_named = template_named
        return real(bufs, tk_spec, dense_spec, anchor_named, template_named)

    comp.decode_shard_device = broken
    try:
        yield
    finally:
        comp.decode_shard_device = real


def drive_compress_control(device: str = "cuda") -> tuple[bool, dict]:
    """Phase ``compress_control``, run only when named: parts (b) and (d)
    under each broken codec of :data:`BROKEN_CODECS`, to read what their
    checks see. Each part's one update through the plane must then differ
    from the byte path (the bit-equality check can fail such a codec), and
    under ``wrong_base`` (nodes that keep their own training) the spreads
    must exceed ``LOSSY_REL_SPREAD``'s. The ``dropped`` spreads are read, not
    held: the spread is a difference of the nodes' own residuals, which
    the receivers' decode does not enter."""
    from p2pfl_tpu_torch.settings import set_test_settings

    readings: dict = {}
    for kind in BROKEN_CODECS:
        with _broken_codec(kind):
            _, ici_part = compress_ici(device)
            set_test_settings()
            _, lora_part = compress_lora(device=device)
            set_test_settings()
        readings[kind] = dict(ici_mlp_spread=ici_part["rel_spread"], lora_spread=lora_part["adapter_rel_spread"],
                              ici_mlp_update_equal=ici_part["updates"]["topk8"]["equal"],
                              ici_mlp_update_err=ici_part["updates"]["topk8"]["max_abs_err"],
                              lora_update_equal=lora_part["update"]["equal"],
                              lora_update_err=lora_part["update"]["max_abs_err"])
    checks = {
        **{f"{k}: the updates differ from the byte path": not (r["ici_mlp_update_equal"] or r["lora_update_equal"])
           for k, r in readings.items()},
        f"wrong_base: the spreads exceed {LOSSY_REL_SPREAD}": (
            readings["wrong_base"]["ici_mlp_spread"] > LOSSY_REL_SPREAD["mlp"]
            and readings["wrong_base"]["lora_spread"] > LOSSY_REL_SPREAD["lora"]),
    }
    ok = all(checks.values())
    log(f"[compress_control] {json.dumps({'readings': readings, 'checks': checks})} {'OK' if ok else 'FAIL'}")
    return ok, readings


# ---- phase 15: BASELINE config 7 (long context, head widths, attn="auto") ----

#: config 7's model (``bench_suite.py:1445-1650``): 4L/256d/8h/kv8 (head
#: dim 32), SwiGLU 688, vocab 1024, batch 8, no adapters
C7 = dict(vocab_size=1024, dim=256, n_layers=4, n_heads=8, n_kv_heads=8, ffn_hidden=688, lora_rank=0)
C7_BATCH = 8
C7_SEQS = (512, 1024, 2048, 4096)
#: train steps of each counted drive (launches are held to steps x layers)
C7_COUNTED_STEPS = 3


def _c7_model(seq: int, attn: str, bwd_mode: str = "auto", device="cuda", **over):
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig

    pin = FlashConfig(bwd_mode=bwd_mode) if attn == "flash" and bwd_mode != "auto" else None
    cfg = TransformerConfig(**{**C7, **over}, flash_config=pin)
    return tiny_transformer(seq_len=seq, seed=0, cfg=cfg, attn=attn, device=device)


def _c7_steps(model, seq: int, device="cuda"):
    """(train step, forward step, loss and gradients) of config 7's
    benchmark on one batch of random tokens: the train step is the loss's
    gradient and an SGD update ``p - 1e-4·g`` in place, as JAX's row."""
    from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_unflatten

    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, C7["vocab_size"], (C7_BATCH, seq), generator=gen).to(device)
    targets = torch.roll(tokens, -1, dims=1)
    paths = [k for k, _ in tree_items(model.params)]
    leaves = [v for _, v in tree_items(model.params)]

    def grads():
        lv = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss = softmax_cross_entropy(model.module(tree_unflatten(dict(zip(paths, lv))), tokens), targets).mean()
            return loss, torch.autograd.grad(loss, lv)

    def train():
        _, g = grads()
        with torch.no_grad():
            torch._foreach_add_(leaves, g, alpha=-1e-4)

    @torch.no_grad()
    def fwd():
        return softmax_cross_entropy(model.module(model.params, tokens), targets).mean()

    return train, fwd, grads


def _train_flops(model, seq: int) -> tuple[int, int]:
    """(forward, forward + backward) FLOPs of config 7's loss on one batch,
    counted on meta tensors (the dense twin: the kernels do not run on meta)."""
    from p2pfl_tpu_torch.parallel.spmd import _model_step_flops

    x = torch.zeros((1, C7_BATCH, seq), dtype=torch.int64)
    return _model_step_flops(model.module, model.params, x, x, C7_BATCH)


def _c7_launches(seq: int, bwd_mode: str = "auto", **over) -> tuple[dict, dict, int]:
    """Launch counts of ``C7_COUNTED_STEPS`` flash train steps: (counts,
    the flash kernels' counts by head width, layers)."""
    from p2pfl_tpu_torch.ops import _kernels

    model = _c7_model(seq, "flash", bwd_mode, **over)
    train, _, _ = _c7_steps(model, seq)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for _ in range(C7_COUNTED_STEPS):
        train()
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    by_width = {k: dict(v) for k, v in _kernels.LAUNCHES_BY_WIDTH.items()}
    return counts, by_width, model.extra["config"].n_layers


def _expected(counts: dict, want: dict) -> bool:
    """Every kernel launched exactly as ``want`` says, every other at 0."""
    return all(counts[k] == want.get(k, 0) for k in counts)


def c7_head_dim_scaling(t: int = 4096) -> dict:
    """The bare kernels at T 4096 with H·D = 256 (8x32, 4x64, 2x128, batch
    8, causal), JAX's ``head_dim_scaling`` rows: forward ms and fwd + bwd
    ms (the backward by difference) with the kernels' FLOP counts' MFU
    (JAX's formulas)."""
    from p2pfl_tpu_torch.ops.flash_attention import flash_attention

    out = {}
    for h, d in ((8, 32), (4, 64), (2, 128)):
        q, k, v, g = randn_inputs((C7_BATCH, t, h, d), 0)
        qg, kg, vg = (x.requires_grad_(True) for x in (q, k, v))

        def fwd():
            with torch.no_grad():
                return flash_attention(q, k, v, True)

        def train():
            return torch.autograd.grad(flash_attention(qg, kg, vg, True), (qg, kg, vg), g)

        fl_fwd = 0.5 * 2 * 2 * C7_BATCH * h * t * t * d
        s_fwd, s_all = time_ms(fwd, iters=10) / 1e3, time_ms(train, iters=10) / 1e3
        s_bwd = max(s_all - s_fwd, 1e-9)
        out[f"D{d}"] = {"fwd_ms": s_fwd * 1e3, "fwd_mfu": fl_fwd / s_fwd / PEAK_BF16_FLOPS,
                        "bwd_ms": s_bwd * 1e3, "bwd_mfu": 2.5 * fl_fwd / s_bwd / PEAK_BF16_FLOPS}
    return out


def drive_config7() -> tuple[bool, dict]:
    """BASELINE config 7 uncut on the card: for T 512-4096 the dense and the
    flash model's forward and train step (ms, MFU of the dense twin's FLOPs
    as JAX's row), ``pick_attention``'s answer and the smallest T where
    flash's train step beats dense's; the bare kernels' head-dim scaling at
    T 4096; the 2-head (D 128) variant; kernels 1 and 2 launched exactly
    steps x layers times in a counted drive at each T (kernels 3 and 4
    under ``bwd_mode="split"`` at T 4096; the D 128 variant's, fused and
    split, at its width), every other kernel at 0; one train step's gradients at T 512
    on the card's kernels against the CPU's plain versions by relative L2
    (``GRAD_REL_L2``)."""
    from p2pfl_tpu_torch.models.transformer import pick_attention
    from p2pfl_tpu_torch.ops.tree import tree_map

    ok = True
    rows: dict = {}
    launches: dict = {}
    widths: dict = {}
    for t in C7_SEQS:
        row = {"auto_picks": pick_attention(t, "cuda")}
        for attn in ("dense", "flash"):
            model = _c7_model(t, attn)
            train, fwd, _ = _c7_steps(model, t)
            row[f"{attn}_fwd_ms"] = time_ms(fwd, iters=10, warmup=2)
            row[f"{attn}_train_ms"] = time_ms(train, iters=10, warmup=2)
            if attn == "dense":
                fl_fwd, fl_train = _train_flops(model, t)
            del model, train, fwd
            torch.cuda.empty_cache()
        for attn in ("dense", "flash"):
            row[f"{attn}_fwd_mfu"] = fl_fwd / (row[f"{attn}_fwd_ms"] / 1e3) / PEAK_BF16_FLOPS
            row[f"{attn}_train_mfu"] = fl_train / (row[f"{attn}_train_ms"] / 1e3) / PEAK_BF16_FLOPS
        row["speedup_train"] = row["dense_train_ms"] / row["flash_train_ms"]
        counts, width, layers = _c7_launches(t)
        n = C7_COUNTED_STEPS * layers
        good = _expected(counts, {"flash_fwd": n, "flash_bwd_dkvq": n}) and width["flash_bwd_dkvq"][32] == n
        row["launches"] = {k: v for k, v in counts.items() if v}
        launches[f"config7_T{t}"], widths[f"config7_T{t}"] = counts, width
        ok &= good
        log(f"[config7] T {t}: {json.dumps(row)} {'OK' if good else 'FAIL'}")
        rows[f"T{t}"] = row
    # the split backward at T 4096, and the D 128 variant (2 heads) at its width
    counts, width, layers = _c7_launches(4096, "split")
    n = C7_COUNTED_STEPS * layers
    good = _expected(counts, {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}) and width["flash_bwd_dq"][32] == n
    launches["config7_split_T4096"], widths["config7_split_T4096"] = counts, width
    counts128, width128, _ = _c7_launches(4096, n_heads=2, n_kv_heads=2)
    good &= (_expected(counts128, {"flash_fwd": n, "flash_bwd_dkvq": n})
             and width128["flash_fwd"][128] == width128["flash_bwd_dkvq"][128] == n)
    launches["config7_D128_T4096"], widths["config7_D128_T4096"] = counts128, width128
    split128, wsplit128, _ = _c7_launches(4096, "split", n_heads=2, n_kv_heads=2)
    good &= (_expected(split128, {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n})
             and wsplit128["flash_bwd_dq"][128] == wsplit128["flash_bwd_dkv"][128] == n)
    launches["config7_D128_split_T4096"], widths["config7_D128_split_T4096"] = split128, wsplit128
    ok &= good
    log(f"[config7] launches, split backward at T 4096: {json.dumps({k: v for k, v in counts.items() if v})}; "
        f"2-head (D 128) variant by width: {json.dumps({k: v for k, v in width128.items() if any(v.values())})}, "
        f"split: {json.dumps({k: v for k, v in wsplit128.items() if any(v.values())})} "
        f"{'OK' if good else 'FAIL'}")
    crossover = next((t for t in C7_SEQS if rows[f"T{t}"]["flash_train_ms"] < rows[f"T{t}"]["dense_train_ms"]), None)

    scaling = c7_head_dim_scaling()
    variant = _c7_model(4096, "flash", n_heads=2, n_kv_heads=2)
    train, _, _ = _c7_steps(variant, 4096)
    v_ms = time_ms(train, iters=10, warmup=2)
    _, v_flops = _train_flops(_c7_model(4096, "dense", n_heads=2, n_kv_heads=2), 4096)
    del variant, train
    torch.cuda.empty_cache()

    # one train step's gradients at T 512 (D 32): card kernels against the CPU's plain versions
    t = 512
    cpu = _c7_model(t, "flash", device="cpu")
    card = _c7_model(t, "flash")
    card.params = tree_map(lambda x: x.to("cuda"), cpu.params)
    _, g_cpu = _c7_steps(cpu, t, "cpu")[2]()
    _, g_gpu = _c7_steps(card, t)[2]()
    grad_err = max(((a.float().cpu() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
                   for a, b in zip(g_gpu, g_cpu))
    good = grad_err <= GRAD_REL_L2
    ok &= good
    summary = {"rows": rows, "flash_beats_dense_from_T": crossover, "head_dim_scaling_T4096": scaling,
               "head_width_variant_T4096": {"model": "4L/256d, 2 heads (D 128)", "train_ms": v_ms,
                                            "train_mfu": v_flops / (v_ms / 1e3) / PEAK_BF16_FLOPS},
               "grad_rel_l2_T512": grad_err, "tol_grad_rel_l2": GRAD_REL_L2, "launches": launches,
               "launches_by_width": widths}
    log(f"[config7] crossover (smallest T where flash's train step beats dense's): {crossover}; head-dim scaling: "
        f"{json.dumps(scaling)}; variant: {json.dumps(summary['head_width_variant_T4096'])}; gradients card vs CPU "
        f"at T {t}: rel L2 {grad_err:.3e} (limit {GRAD_REL_L2}) {'OK' if good else 'FAIL'}")
    return ok, summary


# ---- phase 16: BASELINE config 10's MoE rows (SpmdLmFederation) ----

#: config 10's MoE federation (``bench_suite.py:1756-1846``)
C10 = dict(vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=8, ffn_hidden=256, lora_rank=0,
           n_experts=8, moe_top_k=2)
C10_TARGET, C10_MAX_ROUNDS = 0.60, 12
#: the at-scale MoE model (``_moe_step_at_scale`` and ``config10_moe_scale``:
#: 6L/512d, 8 heads, kv 2, 8 experts, ffn 1408, vocab 4096, seq 512)
C10_SCALE = dict(vocab_size=4096, dim=512, n_layers=6, n_heads=8, n_kv_heads=2, ffn_hidden=1408, lora_rank=0,
                 n_experts=8, moe_top_k=2)
#: part (d): card against CPU, 2 nodes at 2L/64d with 4 experts, fp32, SGD
C10_PAIR = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2, ffn_hidden=64, lora_rank=0,
                n_experts=4, moe_top_k=2)
#: relative L2 of the pair's params after the round: fp32 on both sides
#: with TF32 off, the products summed in other orders
C10_PAIR_REL_L2 = 1e-4


def _moe_fed(cfg_kw: dict, seq: int, nodes: int, batch: int, n_train: int, n_test: int, device="cuda", **kw):
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.spmd_lm import SpmdLmFederation

    cfg = TransformerConfig(**cfg_kw)
    model = tiny_transformer(seq_len=seq, cfg=cfg, device=device)
    data = FederatedDataset.synthetic_lm(vocab_size=cfg.vocab_size, seq_len=seq, n_train=n_train, n_test=n_test)
    return SpmdLmFederation.from_dataset(model, data, n_nodes=nodes, batch_size=batch, vote=False, seed=3,
                                         device=device, **kw)


def _steady_s(fed, rounds: int = 3) -> list:
    """Seconds of ``rounds`` rounds of one epoch, each ended by a synchronize."""
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fed.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def _to_target(fed, target: float, max_rounds: int, epochs: int = 1) -> dict:
    """Rounds of ``epochs`` each, evaluated after each, until the mean
    next-token accuracy reaches ``target``."""
    curve, hit, t0 = [], None, time.perf_counter()
    for r in range(max_rounds):
        fed.run_round(epochs=epochs)
        curve.append(fed.evaluate()["test_acc"])
        if curve[-1] >= target:
            hit = (r + 1, time.perf_counter() - t0)
            break
    return {"acc_curve": curve, "target_acc": target, "rounds_to_target": hit and hit[0],
            "time_to_target_s": hit and hit[1]}


def moe_step_at_scale() -> dict:
    """Part (b): one node's grad step of the at-scale MoE model (batch 16,
    seq 512) with an SGD update: ms a step and the MFU of the executed
    FLOPs (dense dispatch computes every [E, C] expert slot), counted on
    meta tensors."""
    from p2pfl_tpu_torch.learning.learner import _loss
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_unflatten
    from p2pfl_tpu_torch.parallel.spmd import _model_step_flops

    seq, batch = 512, 16
    model = tiny_transformer(seq_len=seq, cfg=TransformerConfig(**C10_SCALE))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, C10_SCALE["vocab_size"], (batch, seq), generator=gen).to("cuda")
    targets = torch.roll(tokens, -1, dims=1)
    paths = [k for k, _ in tree_items(model.params)]
    leaves = [v for _, v in tree_items(model.params)]

    def step():
        lv = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss, _ = _loss(tree_unflatten(dict(zip(paths, lv))), model.module, tokens, targets)
            g = torch.autograd.grad(loss, lv)
        with torch.no_grad():
            torch._foreach_add_(leaves, g, alpha=-1e-4)

    ms = time_ms(step, iters=10, warmup=3)
    x = torch.zeros((1, batch, seq), dtype=torch.int64)
    _, flops = _model_step_flops(model.module, model.params, x, x, batch)
    out = {"model": "6L/512d MoE, 8 experts top-2, ffn 1408, seq 512, batch 16", "n_params": model.param_count,
           "step_ms": ms, "flops_per_step": flops, "mfu_hw": flops / (ms / 1e3) / PEAK_BF16_FLOPS}
    del model, leaves
    torch.cuda.empty_cache()
    return out


def moe_pair(devices=("cpu", "cuda")) -> tuple[bool, dict]:
    """Part (d): one round of 2 nodes at 2L/64d with 4 experts (fp32, SGD)
    on the CPU and on the card from one init and data: the router's
    dispatch of the round's first batch computed on both devices (identical
    from identical probabilities; how many tokens' experts differ when each
    device computes its own), and the params after the round by relative
    L2 (``C10_PAIR_REL_L2``)."""
    from p2pfl_tpu_torch.learning.learner import sgd
    from p2pfl_tpu_torch.models.transformer import moe_route
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map

    feds = {dev: _moe_fed({**C10_PAIR, "dtype": torch.float32}, 32, 2, 8, 32, 16, device=dev, tx=sgd(0.05))
            for dev in devices}
    cpu, card = feds[devices[0]], feds[devices[-1]]
    card.params = tree_map(lambda x: x.to(devices[-1]), cpu.params)
    card.opt_state = card.tx.init(card.params)
    # the first layer's routing of node 0's first training batch
    x = cpu.x_all[0, :8]
    routes = {}
    for dev, fed in feds.items():
        p = tree_map(lambda a: a[0], fed.params)
        h = torch.nn.functional.embedding(x.to(dev).long(), p["embed"])
        blk = fed.module.layers[0]
        h = h + blk.attn(p["layer_0"]["attn"], blk.attn_norm(p["layer_0"]["attn_norm"], h))
        hs = blk.mlp_norm(p["layer_0"]["mlp_norm"], h).reshape(-1, C10_PAIR["dim"])
        routes[dev] = torch.softmax(hs.float() @ p["layer_0"]["mlp"]["router"].float(), -1)
    s = routes[devices[0]].shape[0]
    cap = max(1, int(-(-2 * s // 4) * 1.25))
    same_probs = [moe_route(routes[devices[0]].to(dev), 2, cap)[0].cpu() for dev in devices]
    own = [moe_route(routes[dev], 2, cap)[0].cpu() for dev in devices]
    routing_identical = bool(torch.equal(same_probs[0], same_probs[1]))
    tokens_moved = int(((own[0] > 0) != (own[1] > 0)).any(-1).any(-1).sum())
    for fed in feds.values():
        fed.run_round()
    err = _rel_l2([t.cpu() for t in tree_leaves(card.params)], [t for t in tree_leaves(cpu.params)])
    ok = routing_identical and err <= C10_PAIR_REL_L2
    return ok, {"routing_identical_on_one_input": routing_identical,
                "tokens_routed_otherwise_from_own_logits": tokens_moved, "tokens": s,
                "params_rel_l2": err, "limit": C10_PAIR_REL_L2}


def drive_moe() -> tuple[bool, dict]:
    """BASELINE config 10's MoE rows through ``SpmdLmFederation`` (dense
    attention at seq 128 and 512: no hand kernel runs, every count of
    ``_kernels.LAUNCHES`` must read 0): (a) 8 nodes of the 4L/128d MoE (8
    experts, top-2), vocab 512, seq 128, batch 16, seed 3: rounds to 0.60
    (at most 12), a settling round, 3 steady rounds (s/round, MFU from
    ``round_flops``); (b) the at-scale grad step; (c) the 4-node 113M
    federation (batch 4, seq 512): a warm-up round, 3 timed rounds,
    s/round, MFU, peak memory; (d) one round on the CPU against the card."""
    from p2pfl_tpu_torch.ops import _kernels

    ok = True
    out: dict = {}
    _kernels.reset_launches()
    fed = _moe_fed(C10, 128, 8, 16, 8 * 256, 512)
    a = _to_target(fed, C10_TARGET, C10_MAX_ROUNDS)
    fed.run_round()
    torch.cuda.synchronize()
    secs = _steady_s(fed)
    flops = fed.round_flops()
    s = statistics.median(secs)
    a.update(s_per_round=secs, flops_per_round=flops, mfu=flops / s / PEAK_BF16_FLOPS,
             params=fed.model.param_count)
    good = a["rounds_to_target"] is not None
    ok &= good
    log(f"[moe] (a) 8-node MoE federation: {json.dumps(a)} {'OK' if good else 'FAIL'}")
    out["federation"] = a
    del fed
    torch.cuda.empty_cache()

    b = moe_step_at_scale()
    log(f"[moe] (b) step at scale: {json.dumps(b)}")
    out["step_at_scale"] = b

    torch.cuda.reset_peak_memory_stats()
    fed = _moe_fed(C10_SCALE, 512, 4, 4, 4 * 64, 32)
    fed.run_round()
    torch.cuda.synchronize()
    secs = _steady_s(fed)
    flops = fed.round_flops()
    s = statistics.median(secs)
    c = {"params": fed.model.param_count, "steps_per_round": fed._nb, "s_per_round": secs,
         "flops_per_round": flops, "mfu_hw": flops / s / PEAK_BF16_FLOPS,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[moe] (c) 4-node 113M federation: {json.dumps(c)}")
    out["scale"] = c
    del fed
    torch.cuda.empty_cache()
    counts = dict(_kernels.LAUNCHES)
    good = not any(counts.values())
    ok &= good
    log(f"[moe] hand kernels launched by (a)-(c) (dense attention): {json.dumps(counts)} {'OK' if good else 'FAIL'}")

    good, d = moe_pair()
    ok &= good
    log(f"[moe] (d) one round card vs CPU: {json.dumps(d)} {'OK' if good else 'FAIL'}")
    out["pair"] = d
    return ok, out


def drive_moe_target() -> tuple[bool, dict]:
    """Part (c)'s federation to 0.60: at most 15 rounds of 3 epochs (JAX's
    ``config10_moe_scale`` recipe)."""
    fed = _moe_fed(C10_SCALE, 512, 4, 4, 4 * 64, 32)
    res = _to_target(fed, C10_TARGET, 15, epochs=3)
    ok = res["rounds_to_target"] is not None
    log(f"[moe_target] 4-node 113M MoE federation: {json.dumps(res)} {'OK' if ok else 'FAIL'}")
    return ok, res


# ---- phase 17: the async control plane and durability ----

#: ``bench_async.py::run_threaded``'s fleet (``BENCH_ASYNC.json`` "fleet")
ASYNC_FLEET = dict(nodes=10, n_train=8192, n_test=2048, data_seed=3, batch=64, updates=4, slow_s=0.5, seed=1905)
ASYNC_TARGET_ACC = 0.80
#: ``bench_async.py::run_simulated``'s fleet: slow 10 % at 10x, crash 1 %, drop 1 %
ASYNC_SIM = dict(nodes=1000, updates=6, slow_frac=0.10, slow_factor=10.0, seed=1905, local_lr=0.7)


def _async_settings() -> None:
    """``bench_async.py::_fleet_settings``: the test presets with the JAX
    package's low-latency clocks and the fleet's FedBuff knobs, on the ICI
    plane."""
    from p2pfl_tpu_torch.settings import Settings, set_test_settings

    set_test_settings()
    for name, value in dict(GRPC_TIMEOUT=2.0, HEARTBEAT_PERIOD=0.3, HEARTBEAT_TIMEOUT=1.5, GOSSIP_PERIOD=0.02,
                            GOSSIP_MODELS_PERIOD=0.05, VOTE_TIMEOUT=30.0, AGGREGATION_TIMEOUT=60.0,
                            WAIT_HEARTBEATS_CONVERGENCE=0.4, MESSAGE_RETRY_BASE=0.1, MESSAGE_RETRY_CAP=0.8,
                            BREAKER_SUSPECT_TIMEOUT=0.8, TRAIN_SET_SIZE=10, FEDBUFF_K=4, FEDBUFF_ALPHA=0.5,
                            FEDBUFF_SERVER_LR=1.0, ASYNC_MAX_STALENESS=16, ASYNC_DRAIN_TIMEOUT=20.0,
                            WEIGHTS_PLANE="ici", HIER_CLUSTER_SIZE=0, BYZ_SCREEN=False,
                            ASYNC_ROBUST_AGG="fedavg", BYZ_SUSPICION_BETA=0.5).items():
        setattr(Settings, name, value)


def _async_nodes(n: int, device: str, data, addr_prefix: str = "node", slices=None):
    """``n`` Nodes of the 784-256-128-10 MLP, each learner on its own slot
    of ``submesh_federation_mesh(n, devices=[device] * n)`` (so every ICI
    delivery is a real transfer), started and fully connected."""
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
    from p2pfl_tpu_torch.utils import full_connection, wait_convergence

    slices = slices or node_slices(submesh_federation_mesh(n, devices=[device] * n))
    nodes = [Node(learner=TorchLearner(mlp(seed=i, device=device), data.partition(i, n),
                                       batch_size=ASYNC_FLEET["batch"], seed=i, mesh=slices[i]),
                  address=f"{addr_prefix}-{i}") for i in range(n)]
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True, wait=30)
    return nodes, slices


def _full_test_acc(learner, data) -> float:
    """The fleet model's accuracy on the whole held-out set."""
    from p2pfl_tpu_torch.learning.learner import eval_step

    x, y = data.test_arrays()
    dev = learner.device
    _loss, acc = eval_step(learner.get_parameters(), torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                           learner.module)
    return float(acc)


def _plane_counts() -> dict:
    """Kernel 9's launches, the ICI plane's counters and its fallbacks by
    reason (the plane's ``ici_fallback`` events)."""
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.ops import _kernels

    reasons: dict = {}
    for s in telemetry.spans():
        if s.name == "ici_fallback":
            r = (s.attrs or {}).get("reason", "?")
            reasons[r] = reasons.get(r, 0) + 1
    return {"launches_ici_exchange": _kernels.LAUNCHES["ici_exchange"], "ici_stats": ici_mod.ici_stats(),
            "fallbacks_by_reason": reasons}


def _reset_counts() -> None:
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.communication.memory import MemoryRegistry
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.ops import _kernels

    MemoryRegistry.reset()
    ici_mod.ShardPlaneRegistry.reset()
    ici_mod.reset_ici_stats()
    _kernels.reset_launches()
    logger.reset_comm_metrics()
    telemetry.reset()


def _comm_sums(prefixes=("async", "byz", "screen", "journal", "node_resumed", "train_set_repair", "root_failover",
                         "membership_changed", "fault_")) -> dict:
    from p2pfl_tpu_torch.management.logger import logger

    out: dict = {}
    for d in logger.get_comm_metrics().values():
        for k, v in d.items():
            if k.startswith(prefixes):
                out[k] = out.get(k, 0) + int(v)
    return dict(sorted(out.items()))


def _staleness() -> dict:
    from p2pfl_tpu_torch.management.telemetry import telemetry

    return {k.split("/")[0]: v for k, v in telemetry.value_histograms().items() if k.endswith("/staleness")}


def async_threaded(mode: str, device: str = "cuda", fleet: dict = ASYNC_FLEET) -> dict:
    """``bench_async.py::run_threaded`` on the port: a fresh fleet in
    ``mode`` (``sync`` rounds, flat ``async`` FedBuff or ``hier`` with
    clusters of 4) under ``_make_plan``'s seeded faults (the last node slow
    on inbound weights, the one before it crashed at its update 1, 1 %
    drops), every payload between nodes on the ICI plane. Returns the row:
    wall seconds to the survivors' finish, least and most accuracy of the
    survivors' final models on the whole test set, the comm counters, the
    staleness histogram, kernel 9's launches beside the plane's counters."""
    from p2pfl_tpu_torch.communication.faults import CrashSpec, EdgeFault, FaultPlan, install_fault_plan, remove_fault_plan
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.settings import Settings
    from p2pfl_tpu_torch.utils import wait_to_finish

    _async_settings()
    Settings.FEDERATION_MODE = "sync" if mode == "sync" else "async"
    Settings.HIER_CLUSTER_SIZE = 4 if mode == "hier" else 0
    _reset_counts()
    n = fleet["nodes"]
    data = FederatedDataset.synthetic_mnist(n_train=fleet["n_train"], n_test=fleet["n_test"], seed=fleet["data_seed"])
    nodes, _ = _async_nodes(n, device, data, addr_prefix=f"{mode}")
    addrs = [x.addr for x in nodes]
    plan = FaultPlan(seed=fleet["seed"], default=EdgeFault(drop=0.01), slow_nodes={addrs[-1]: fleet["slow_s"]},
                     crashes={addrs[-2]: CrashSpec(stage="TrainStage" if mode == "sync" else "AsyncTrainStage",
                                                   round_no=1)})
    install_fault_plan(nodes, plan)
    survivors = nodes[:-2] + nodes[-1:]
    try:
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=fleet["updates"], epochs=1)
        wait_to_finish(survivors, timeout=300)
        wall = time.monotonic() - t0
        if device != "cpu":
            torch.cuda.synchronize()
        accs = [_full_test_acc(x.learner, data) for x in survivors]
        row = {"mode": mode, "wall_s": wall, "final_acc_min": min(accs), "final_acc_max": max(accs),
               "crashed": not nodes[-2].is_running(), "comm": _comm_sums(), "staleness": _staleness(),
               **_plane_counts()}
    finally:
        remove_fault_plan(nodes)
        for x in nodes:
            x.stop()
        Settings.FEDERATION_MODE = "sync"
    return row


def async_byzantine(device: str = "cuda", fleet: dict = ASYNC_FLEET, n: int = 6) -> dict:
    """A live async federation of ``n`` MLP Nodes with one sign-flip
    attacker (an edge), the admission screen on, the trimmed mean and
    ``BYZ_SUSPICION_BETA=0.8`` (one clear rejection quarantines): the
    attacker must be evicted and the survivors reach the target."""
    from p2pfl_tpu_torch.communication.faults import ByzantineSpec, FaultPlan, install_fault_plan, remove_fault_plan
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.settings import Settings
    from p2pfl_tpu_torch.utils import wait_to_finish

    _async_settings()
    Settings.FEDERATION_MODE = "async"
    Settings.BYZ_SCREEN = True
    Settings.ASYNC_ROBUST_AGG = "trimmed-mean"
    Settings.BYZ_SUSPICION_BETA = 0.8
    _reset_counts()
    data = FederatedDataset.synthetic_mnist(n_train=fleet["n_train"], n_test=fleet["n_test"], seed=fleet["data_seed"])
    nodes, _ = _async_nodes(n, device, data, addr_prefix="byz")
    attacker = nodes[1]  # node byz-0 sorts first: the root; byz-1 is an edge
    install_fault_plan(nodes, FaultPlan(seed=fleet["seed"], byzantine={attacker.addr: ByzantineSpec(kind="sign_flip")}))
    survivors = [x for x in nodes if x is not attacker]
    try:
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=fleet["updates"], epochs=1)
        wait_to_finish(nodes, timeout=300)
        wall = time.monotonic() - t0
        accs = [_full_test_acc(x.learner, data) for x in survivors]
        return {"nodes": n, "attacker": attacker.addr, "wall_s": wall, "final_acc_min": min(accs),
                "final_acc_max": max(accs), "comm": _comm_sums(), **_plane_counts()}
    finally:
        remove_fault_plan(nodes)
        for x in nodes:
            x.stop()
        for name, value in (("FEDERATION_MODE", "sync"), ("BYZ_SCREEN", False), ("ASYNC_ROBUST_AGG", "fedavg"),
                            ("BYZ_SUSPICION_BETA", 0.5)):
            setattr(Settings, name, value)


def async_resume(device: str = "cuda", fleet: dict = ASYNC_FLEET, n: int = 5) -> dict:
    """The kill-and-resurrect drill: ``n`` Nodes paced at 0.3 s an update,
    10 updates each; a journal in a temporary directory on one edge, killed
    at its update 2 by a ``RestartSpec`` and brought back
    by ``Node.resume`` onto ``device``, on its own slot. Its learner must
    hold the params of its last committed snapshot bit for bit (recorded
    at the commit), and the root's version vector must accept its first
    push after the resume (a replay would be dropped)."""
    import tempfile

    from p2pfl_tpu_torch.communication.faults import FaultPlan, RestartSpec, install_fault_plan, remove_fault_plan
    from p2pfl_tpu_torch.federation import buffer as buffer_mod
    from p2pfl_tpu_torch.federation.staleness import as_version
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.settings import Settings
    from p2pfl_tpu_torch.utils import wait_to_finish

    _async_settings()
    Settings.FEDERATION_MODE = "async"
    Settings.FEDBUFF_K = 2
    _reset_counts()
    data = FederatedDataset.synthetic_mnist(n_train=fleet["n_train"], n_test=fleet["n_test"], seed=fleet["data_seed"])
    nodes, slices = _async_nodes(n, device, data, addr_prefix="rz")
    victim = nodes[3]
    jdir = tempfile.mkdtemp(prefix="p2pfl-journal-")
    victim.enable_journal(jdir)
    committed: list = []  # host copies of the victim's params at each commit
    journal = victim.journal
    real_commit = journal.commit_snapshot

    def commit(snap, learner=None):
        name = real_commit(snap, learner=learner)
        committed.append([x.detach().cpu().clone() for x in tree_leaves(learner.get_parameters())])
        return name

    journal.commit_snapshot = commit
    offers: list = []  # (origin, seq, accepted) of every offer at any buffer
    real_offer = buffer_mod.BufferedAggregator.offer

    def offer(self, update, screen_origin=None):
        ver = as_version(update.version)
        before = self._vv.last(ver.origin) if ver is not None else None
        res = real_offer(self, update, screen_origin=screen_origin)
        if ver is not None:
            offers.append((ver.origin, ver.seq, time.monotonic(), before < ver.seq == self._vv.last(ver.origin)))
        return res

    revived: list = []
    checks: dict = {}

    def resurrect(addr):
        learner = TorchLearner(mlp(seed=99, device=device), data.partition(3, n), batch_size=fleet["batch"], seed=99,
                               mesh=slices[3])
        checks["resume_t"] = time.monotonic()
        node = Node.resume(jdir, learner=learner, rounds=2)
        # read before the workflow adopts a global: it first waits
        # WAIT_HEARTBEATS_CONVERGENCE (0.4 s) for the overlay
        got = [x.detach().cpu() for x in tree_leaves(node.learner.get_parameters())]
        checks["resumed params bit-equal to the last committed snapshot"] = bool(committed) and all(
            torch.equal(a, b) for a, b in zip(got, committed[-1], strict=True))
        checks["resumed learner on the card" if device != "cpu" else "resumed learner on the CPU"] = all(
            x.device.type == torch.device(device).type for x in tree_leaves(node.learner.get_parameters()))
        revived.append(node)

    install_fault_plan(nodes, FaultPlan(seed=7, restarts={victim.addr: RestartSpec(round_no=2, resume_after_s=1.0)}),
                       resurrect_fn=resurrect)

    def pace(node, stage_name):
        # the fleet keeps training while the victim dies and comes back:
        # its pushes after the resume must still find the root's buffer
        if stage_name == "AsyncTrainStage":
            time.sleep(0.3)

    for x in nodes:
        x.stage_hooks.append(pace)
    buffer_mod.BufferedAggregator.offer = offer
    try:
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=10, epochs=1)
        deadline = time.monotonic() + 120
        while not revived and time.monotonic() < deadline:
            time.sleep(0.05)
        survivors = [x for x in nodes if x is not victim] + revived
        wait_to_finish(survivors, timeout=300)
        wall = time.monotonic() - t0
        after = [(seq, ok) for origin, seq, t, ok in offers if origin == victim.addr and t >= checks.get("resume_t", 1e18)]
        accs = [_full_test_acc(x.learner, data) for x in survivors]
        return {"nodes": n, "victim": victim.addr, "wall_s": wall, "snapshots_committed": len(committed),
                "post_resume_offers": after[:6], "final_acc_min": min(accs), "final_acc_max": max(accs),
                "checks": {**{k: v for k, v in checks.items() if k != "resume_t"},
                           "resurrected": bool(revived),
                           "first push after the resume accepted": bool(after) and after[0][1]},
                "comm": _comm_sums(), **_plane_counts()}
    finally:
        buffer_mod.BufferedAggregator.offer = real_offer
        remove_fault_plan(nodes)
        for x in nodes + revived:
            x.stop()
        Settings.FEDERATION_MODE = "sync"
        Settings.FEDBUFF_K = 4


def async_simulated(device: str, cluster: int, sim: dict = ASYNC_SIM) -> tuple:
    """``bench_async.py::run_simulated``'s fleet on ``device``: → (result,
    host seconds)."""
    from p2pfl_tpu_torch.communication.faults import CrashSpec, EdgeFault, FaultPlan
    from p2pfl_tpu_torch.federation.simfleet import SimulatedAsyncFleet

    n = sim["nodes"]
    addrs = [f"sim-{i:04d}" for i in range(n)]
    plan = FaultPlan(seed=sim["seed"], default=EdgeFault(drop=0.01),
                     crashes={a: CrashSpec(stage="AsyncTrainStage", round_no=2) for a in addrs[7::100][:max(1, n // 100)]})
    fleet = SimulatedAsyncFleet(n, seed=sim["seed"], cluster_size=cluster, updates_per_node=sim["updates"],
                                slow_frac=sim["slow_frac"], slow_factor=sim["slow_factor"], plan=plan,
                                local_lr=sim["local_lr"], device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t = time.perf_counter()
    res = fleet.run()
    if device != "cpu":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t


def async_update_through_plane(device: str = "cuda") -> dict:
    """One ``async_update`` between two MLP Nodes on their own slots of
    ``device`` over the ICI plane, against the byte path's
    ``encode_params`` → ``decode_params`` of the same update: the
    receiver's ``async_update`` handler is swapped for a capture. → the
    check results, kernel 9's launches and the version triple that
    arrived."""
    from p2pfl_tpu_torch.commands.command import Command
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.weights import ModelUpdate, decode_params, encode_params
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_items

    _async_settings()
    _reset_counts()
    data = FederatedDataset.synthetic_mnist(n_train=512, n_test=64, seed=3)
    nodes, _ = _async_nodes(2, device, data, addr_prefix="plane")
    got: list = []

    class Capture(Command):
        @staticmethod
        def get_name() -> str:
            return "async_update"

        def execute(self, source, round, *args, update=None, **kwargs):  # noqa: A002
            got.append(update)

    try:
        src, dst = nodes
        dst.protocol.add_command(Capture())
        src.learner.fit()
        upd = ModelUpdate(src.learner.get_parameters(), [src.addr], 64, xp="xp-plane", version=(src.addr, 7, 3))
        sent = src.protocol.send(dst.addr, src.protocol.build_weights("async_update", 0, upd), create_connection=True)
        if device != "cpu":
            torch.cuda.synchronize()
        want = decode_params(encode_params(upd.params))
        leaves = dict(tree_items(got[0].params)) if got else {}
        return {
            "sent": sent, "version": got[0].version if got else None,
            "launches_ici_exchange": _kernels.LAUNCHES["ici_exchange"], **_plane_counts(),
            "checks": {
                "delivered": bool(got),
                "version triple and xp intact": bool(got) and tuple(got[0].version) == (src.addr, 7, 3)
                and got[0].xp == "xp-plane",
                "bit-equal to the byte path": bool(got) and leaves.keys() == want.keys() and all(
                    torch.equal(leaves[k].cpu(), want[k]) for k in want),
                "on the receiver's device": bool(got) and all(
                    x.device.type == torch.device(device).type for x in leaves.values()),
                # one delivery, by one launch of kernel 9 on a card (the
                # plain copy on the CPU)
                "kernel 9 moved it" if device != "cpu" else "the plane moved it":
                    ici_mod.ici_stats()["shard_sends"] == 1
                    and (device == "cpu" or _kernels.LAUNCHES["ici_exchange"] == 1),
            },
        }
    finally:
        for x in nodes:
            x.stop()


def drive_async(device: str = "cuda", fleet: dict = ASYNC_FLEET, sim: dict = ASYNC_SIM) -> tuple[bool, dict]:
    """The async control plane and its durability on the card, parts
    (a)-(d) (see the module docs); each part fails the phase on its own."""
    import logging

    from p2pfl_tpu_torch.management.logger import logger

    logger.set_level("WARNING")
    failures: list = []

    class _Failed(logging.Handler):
        def emit(self, record):
            if "ICI shard transfer" in record.getMessage() or "Async workflow failed" in record.getMessage():
                failures.append(record.getMessage())

    handler = _Failed()
    logger._logger.addHandler(handler)
    ok = True
    out: dict = {"threaded": {}}
    try:
        plane = async_update_through_plane(device)
        good = all(plane["checks"].values())
        ok &= good
        out["plane"] = plane
        log(f"[async] (a) one async_update over the ICI plane against the byte path: {json.dumps(plane)} "
            f"{'OK' if good else 'FAIL'}")
        for mode in ("sync", "async", "hier"):
            row = async_threaded(mode, device, fleet)
            stats = row["ici_stats"]
            checks = {
                f"least accuracy >= {ASYNC_TARGET_ACC}": row["final_acc_min"] >= ASYNC_TARGET_ACC,
                "victim crashed": row["crashed"],
                "kernel 9 launched" if device != "cpu" else "plain exchange ran": stats["shard_sends"] > 0,
                "kernel 9 launches == shard sends": device == "cpu" or row["launches_ici_exchange"] == stats["shard_sends"],
                "no ici fallback": stats["fallback_bytes"] == 0 and not row["fallbacks_by_reason"],
                "no alignment fix-up": stats["align_violations"] == 0,
            }
            if mode != "sync":
                checks["async merges"] = row["comm"].get("async_merge", 0) > 0
            row["checks"] = checks
            good = all(checks.values())
            ok &= good
            out["threaded"][mode] = row
            log(f"[async] (a) {mode}: wall {row['wall_s']:.3f} s, accuracy {row['final_acc_min']:.4f}-"
                f"{row['final_acc_max']:.4f}, kernel 9 {row['launches_ici_exchange']} launches for "
                f"{stats['shard_sends']} shard sends, fallbacks {row['fallbacks_by_reason']}; "
                f"{json.dumps(row)} {'OK' if good else 'FAIL'}")
        b = async_byzantine(device, fleet)
        b["checks"] = {
            "byz_evicted fired": b["comm"].get("byz_evicted", 0) >= 1,
            "screen rejected": b["comm"].get("screen_reject", 0) >= 1,
            f"survivors' least accuracy >= {ASYNC_TARGET_ACC}": b["final_acc_min"] >= ASYNC_TARGET_ACC,
            "no ici fallback": b["ici_stats"]["fallback_bytes"] == 0,
        }
        good = all(b["checks"].values())
        ok &= good
        out["byzantine"] = b
        log(f"[async] (b) Byzantine: {json.dumps(b)} {'OK' if good else 'FAIL'}")
        c = async_resume(device, fleet)
        c["checks"]["survivors' finite accuracy"] = math.isfinite(c["final_acc_min"])
        good = all(c["checks"].values())
        ok &= good
        out["resume"] = c
        log(f"[async] (c) kill and resurrect: {json.dumps(c)} {'OK' if good else 'FAIL'}")
        out["simulated"] = {}
        for name, cluster in (("flat", 0), ("hier_cluster32", 32)):
            card, card_s = async_simulated(device, cluster, sim)
            host, host_s = async_simulated("cpu", cluster, sim)
            curve = lambda r: [(t, v) for t, v, _ in r.loss_curve]  # noqa: E731
            losses = np.asarray([l for *_, l in card.loss_curve]), np.asarray([l for *_, l in host.loss_curve])
            d = {"nodes": sim["nodes"], "updates_per_node": sim["updates"], "merges": card.merges,
                 "versions": card.version, "host_s": card_s, "host_s_cpu_fleet": host_s,
                 "makespan_virtual_s": card.virtual_time, "crashed": len(card.crashed),
                 "updates_sent": card.updates_sent, "final_loss": card.final_loss(),
                 "loss_max_rel_gap_vs_cpu": float(np.max(np.abs(losses[0] - losses[1]) / np.maximum(losses[1], 1e-30)))
                 if len(losses[0]) == len(losses[1]) and len(losses[0]) else None}
            d["checks"] = {
                "merge count equals the CPU's": card.merges == host.merges,
                "version sequence (and merge times) equal the CPU's": curve(card) == curve(host),
                "crashed equal": card.crashed == host.crashed,
                "finite losses": bool(np.all(np.isfinite(losses[0]))),
                "params on the card": card.params["w"].device.type == torch.device(device).type,
            }
            good = all(d["checks"].values())
            ok &= good
            out["simulated"][name] = d
            log(f"[async] (d) simulated {name}: {sim['nodes']} nodes x {sim['updates']} updates, "
                f"{card.merges} merges, host {card_s:.3f} s (CPU fleet {host_s:.3f} s), virtual makespan "
                f"{card.virtual_time:.3f} s; {json.dumps(d)} {'OK' if good else 'FAIL'}")
    finally:
        logger._logger.removeHandler(handler)
    if failures:
        ok = False
        log(f"[async] failure logs: {failures[:3]} FAIL")
    return ok, out


#: ``bench_async.py``'s megafleet_1m row: FleetSpec.synth(1M, seed 1905,
#: 10 % slow at 10x), dim 16, clusters of 1024, K 64, 4 updates a client,
#: the consensus task at local lr 0.7, 256 events a chunk
MEGAFLEET = dict(n=1_000_000, seed=1905, slow_frac=0.10, cluster=1024, k=64, updates=4, local_lr=0.7, chunk=256)
#: BENCH_ASYNC.json's integer counts of that fleet (they do not depend on
#: the device: JAX's engine on a CPU)
MEGAFLEET_COUNTS = {"events": 4_000_000, "merges": 976, "regional_merges": 62_500}
#: the JAX tests' chunked-against-per-event fleet
MF_SMALL = dict(n=500, seed=1905, dim=8, k=8, updates=4, local_lr=0.7)
#: params of the kernel against its twin and of the chunked engine against
#: the per-event engine on the card, as a share of the largest |value|:
#: the fedavg and trimmed-mean sums run in another order (ulps a fold)
MF_PARAM_TOL = 1e-5
#: the carry's integer and time fields, which must be equal bit for bit
MF_EXACT = ("si", "hist_edge", "hist_glob", "mint", "sf", "gkey_hi", "gkey_lo", "rcount", "radopt", "up_seq",
            "last_acc_r", "rkey_hi", "rkey_lo", "rsamp")
MF_CLOSE = ("G", "w", "gbuf", "gwt", "rbuf", "rwt", "rparams")


def _mf_curves(res):
    return (np.asarray([x[0] for x in res.loss_curve]), [x[1] for x in res.loss_curve],
            np.asarray([x[2] for x in res.loss_curve]))


def megafleet_pair(cluster: int, device: str = "cuda") -> dict:
    """The JAX tests' ``_pair``: ``SimulatedAsyncFleet(1000)`` and
    ``MegaFleet`` on its exported population, both on ``device``: merges
    and the version sequence exact, mint times within 1e-4, losses within
    the JAX tests' limits (flat 1e-5 of the largest, hier 0.15 and the
    final loss within 1e-2), flat params within 1e-5."""
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, MegaFleet
    from p2pfl_tpu_torch.federation.simfleet import SimulatedAsyncFleet

    fleet = SimulatedAsyncFleet(1000, seed=1905, cluster_size=cluster, updates_per_node=4, slow_frac=0.1,
                                local_lr=0.7, device=device)
    spec = FleetSpec.from_sim(fleet)
    heap, heap_s = _timed_s(fleet.run)
    mega = MegaFleet(spec, cluster_size=cluster, updates_per_node=4, local_lr=0.7, device=device)
    res, mega_s = _timed_s(mega.run)
    ht, hv, hl = _mf_curves(heap)
    mt, mv, ml = _mf_curves(res)
    same_len = len(mt) == len(ht)
    loss_gap = float(np.max(np.abs(ml - hl))) if same_len and len(hl) else None
    final_rel = abs(res.final_loss() - heap.final_loss()) / max(heap.final_loss(), 1e-9)
    mint_gap = float(np.max(np.abs(mt - ht), initial=0.0)) if same_len else math.inf
    # hier: an aggregate is offered at its regional's flush, so its mint
    # time may differ from the heap's by up to one link delay (JAX's own
    # engine: 0.0099 s at this fleet)
    mint_tol = fleet.link_delay if cluster else 1e-4
    checks = {
        "merges equal": res.merges == heap.merges > 0,
        "version sequence equal": mv == hv,
        f"mint times within {mint_tol:g}": mint_gap <= mint_tol,
    }
    if cluster:
        checks["losses within 0.15 of the largest"] = loss_gap is not None and loss_gap <= float(hl.max()) * 0.15
        checks["final loss within 1e-2"] = final_rel <= 1e-2
    else:
        checks["losses within 1e-5 of the largest"] = loss_gap is not None and loss_gap <= float(hl.max()) * 1e-5
        checks["params within 1e-5"] = float((res.params["w"] - heap.params["w"]).abs().max()) <= 1e-5
    return {"cluster": cluster, "merges": res.merges, "heap_merges": heap.merges, "heap_s": heap_s,
            "megafleet_s": mega_s, "mint_max_gap": mint_gap, "loss_max_gap": loss_gap, "final_loss_rel_gap": final_rel,
            "on_device": res.params["w"].device.type, "checks": checks}


def _mf_small(**kw):
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, MegaFleet

    spec = FleetSpec.synth(MF_SMALL["n"], seed=MF_SMALL["seed"], dim=MF_SMALL["dim"])
    return MegaFleet(spec, k=MF_SMALL["k"], updates_per_node=MF_SMALL["updates"], local_lr=MF_SMALL["local_lr"],
                     **kw)


def megafleet_engines(device: str = "cuda") -> dict:
    """(b) the chunked engine (the kernel) against the per-event engine
    (torch ops), both on ``device``: 500 clients, dim 8, K 8, chunks 7, 48
    and 256, flat and clusters of 32. Merges, regional merges, versions,
    mint times and histograms exact; params within ``MF_PARAM_TOL`` of
    the largest value (and whether they came out bit-equal)."""
    rows = {}
    for cluster in (0, 32):
        ref = _mf_small(cluster_size=cluster, chunk=1, device=device).run()
        for chunk in (7, 48, 256):
            got = _mf_small(cluster_size=cluster, chunk=chunk, device=device).run()
            gap = float((got.params["w"] - ref.params["w"]).abs().max())
            scale = float(ref.params["w"].abs().max())
            rows[f"cluster{cluster}_chunk{chunk}"] = {
                "merges": got.merges, "regional_merges": got.regional_merges, "params_max_abs_gap": gap,
                "params_bit_equal": gap == 0.0,
                "checks": {
                    "merges, regional merges, versions, mint times exact": (
                        got.merges, got.regional_merges, [x[:2] for x in got.loss_curve]) == (
                        ref.merges, ref.regional_merges, [x[:2] for x in ref.loss_curve]),
                    "staleness histograms exact": (got.staleness_hist_edge, got.staleness_hist_global) == (
                        ref.staleness_hist_edge, ref.staleness_hist_global),
                    f"params within {MF_PARAM_TOL:g} of the largest": gap <= MF_PARAM_TOL * scale,
                }}
    return rows


def _mf_attack(fold: str, cluster: int):
    """The (c) robust case: 5 % of the 500 clients flip their payloads'
    sign; the window folds by ``fold``."""
    from p2pfl_tpu_torch.communication.faults import ByzantineSpec, FaultPlan

    n = MF_SMALL["n"]
    byz = {f"sim-{i:04d}": ByzantineSpec(kind="sign_flip") for i in range(3, n, 20)}
    return _mf_small(cluster_size=cluster, chunk=48, fold=fold, plan=FaultPlan(seed=1905, byzantine=byz),
                     device="cuda")


def _mf_faults(kind: str):
    """(c)'s fault cases on 300 clients: ``chaos`` (drop, jitter,
    duplicates, slow aggregators, a crash; pace steering, selection and
    both rate limits), ``byzantine`` (every stateless kind at the edge and
    at elected regionals' aggregate sends), ``churn`` (joins and a
    graceful and an abrupt leave)."""
    from p2pfl_tpu_torch.communication import faults as f
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, MegaFleet

    n, seed = 300, MF_SMALL["seed"]
    spec = FleetSpec.synth(n, seed=seed, dim=MF_SMALL["dim"], slow_frac=0.1)
    kw = dict(updates_per_node=4, local_lr=0.7, chunk=48, device="cuda")
    if kind == "chaos":
        plan = f.FaultPlan(seed=seed, default=f.EdgeFault(drop=0.05, jitter=0.002, duplicate=0.2),
                           slow_nodes={f"sim-{i:04d}": 0.3 for i in range(1, n, 37)},
                           crashes={"sim-0007": f.CrashSpec(stage="AsyncTrainStage", round_no=2)})
        return MegaFleet(spec, cluster_size=16, k=4, plan=plan, pace_window=0.4, select_frac=0.8,
                         rate_limit_regional=0.02, rate_limit_global=0.01, **kw)
    if kind == "byzantine":
        plan = f.FaultPlan(seed=seed, byzantine={
            f"sim-{i:04d}": f.ByzantineSpec(kind=("sign_flip", "scale", "noise")[i % 3], lam=5.0, noise_std=2.0)
            for i in range(0, n, 16)})
        return MegaFleet(spec, cluster_size=16, k=4, plan=plan, **kw)
    plan = f.FaultPlan(seed=seed, joins={f"sim-{i:04d}": f.JoinSpec(at_s=1.5 + 0.1 * (i - n + 6))
                                          for i in range(n - 6, n)},
                       leaves={"sim-0005": f.LeaveSpec(at_s=2.5, graceful=True),
                               "sim-0033": f.LeaveSpec(at_s=3.0, graceful=False)})
    return MegaFleet(spec, cluster_size=32, plan=plan, **kw)


def _mf_grad(kind: str, cluster: int, device: str = "cuda"):
    """(c)'s gradient-task fleets: 200 clients each train a tiny ``kind``
    model (SGD on teacher-labelled clouds), K 4 and 48 events a chunk, so
    a chunk mints several times and its later lanes adopt those mints: the
    kernel stops before each such lane, the host runs the task's round
    from the mint, the kernel resumes there."""
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, GradTask, MegaFleet

    task = GradTask(kind=kind, d_in=6, n_out=3, hidden=8 if kind == "mlp" else 0, batch=4, steps=2, data_seed=5)
    spec = FleetSpec.synth(200, seed=MF_SMALL["seed"], dim=task.param_dim())
    return MegaFleet(spec, cluster_size=cluster, k=4, updates_per_node=4, local_lr=0.3, task=task, chunk=48,
                     device=device)


def compare_carries(card, host) -> tuple[bool, float, float]:
    """(integer and time fields equal, the largest param gap, the largest
    |param|) of two chunked engines' carries; the client rows' adopted
    version column is an integer field."""
    exact, gap, scale = True, 0.0, 0.0
    for name in MF_EXACT:
        if name in card.carry:
            exact &= torch.equal(card.carry[name].cpu(), host.carry[name].cpu())
    for name in MF_CLOSE:
        if name in card.carry:
            a, b = card.carry[name].cpu(), host.carry[name].cpu()
            if name == "w":
                exact &= torch.equal(a[:, -1], b[:, -1])
                a, b = a[:, :-1], b[:, :-1]
            gap = max(gap, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
    return exact, gap, scale


def megafleet_kernel_vs_twin() -> dict:
    """(c) the kernel against its plain twin on the same inputs: the
    streams of (b), the median and trimmed-mean folds under a 5 %
    sign-flip attack (flat and clusters of 32), and the fault fleets of
    :func:`_mf_faults` (rate limits, duplicates, every Byzantine kind at
    both seams, churn's per-epoch K) and the gradient-task fleets of
    :func:`_mf_grad` (linear flat, mlp in clusters of 16). Each fleet's chunked
    engine runs twice on the card as :meth:`ChunkedFleet.run` runs it (a
    consensus fleet in one launch) and once on the CPU (the twin): the two
    card runs bit-equal in every field; the integer and time fields of the
    carry (counters, histograms, mint times, window keys, regional
    counters) equal the twin's; params within ``MF_PARAM_TOL`` of the
    largest. A consensus fleet also runs chunk by chunk with the
    regionals' counters in device memory, and with PyTorch's pass A
    (the kernel stopping at each lane an in-chunk mint moved): both
    bit-equal to the one-launch run."""
    from p2pfl_tpu_torch.ops import _kernels

    cases = {f"cluster{c}_chunk{k}": _mf_small(cluster_size=c, chunk=k, device="cuda")
             for c in (0, 32) for k in (7, 48, 256)}
    cases.update({f"{fold}_signflip_cluster{c}": _mf_attack(fold, c)
                  for fold in ("median", "trimmed-mean") for c in (0, 32)})
    cases.update({f"{kind}_300": _mf_faults(kind) for kind in ("chaos", "byzantine", "churn")})
    cases.update({"linear_task_flat": _mf_grad("linear", 0), "mlp_task_cluster16": _mf_grad("mlp", 16)})
    rows, worst, launches = {}, 0.0, 0
    for name, mega in cases.items():
        _kernels.reset_launches()
        runs = [mega.chunked_engine() for _ in range(2)]
        for eng in runs:
            eng.run()
        torch.cuda.synchronize()
        n_launches = _kernels.LAUNCHES["fleet_chunk"]
        launches += n_launches
        twin = mega.chunked_engine(device="cpu")
        twin.run()
        exact, gap, scale = compare_carries(runs[0], twin)
        repeat = all(torch.equal(runs[0].carry[k], runs[1].carry[k]) for k in runs[0].carry)
        worst = max(worst, gap)
        si = runs[0].carry["si"].cpu().tolist()
        consensus = mega.task is None
        want = 2 * (1 if consensus else runs[0].n_chunks) + runs[0].resumes + runs[1].resumes
        rows[name] = {"merges": si[2], "regional_merges": si[7], "params_max_abs_gap": gap,
                      "resumes": runs[0].resumes, "launches": n_launches,
                      "checks": {"integers and times equal the twin's": exact,
                                 f"params within {MF_PARAM_TOL:g} of the largest": gap <= MF_PARAM_TOL * max(scale, 1.0),
                                 "two card runs bit-equal": repeat,
                                 "launches exact": n_launches == want,
                                 "merged": si[2] > 0}}
        if not consensus:
            rows[name]["checks"]["the kernel stopped at retrained lanes and resumed"] = runs[0].resumes > 0
            continue
        stepped = mega.chunked_engine()
        stepped.reg_layout = "device"
        for s in range(stepped.n_chunks):
            stepped.step(s)
        staged = mega.chunked_engine()
        staged.torch_pass_a = True
        staged.run()
        rows[name]["checks"].update({
            "chunk by chunk, counters in device memory: bit-equal": all(
                torch.equal(runs[0].carry[k], stepped.carry[k]) for k in runs[0].carry),
            "PyTorch's pass A (the kernel stopping at moved lanes): bit-equal": all(
                torch.equal(runs[0].carry[k], staged.carry[k]) for k in runs[0].carry)})
    return {"cases": rows, "max_abs_err": worst, "launches": launches}


def _profiled(fn) -> tuple[list, float]:
    """``fn()`` under ``torch.profiler``: its device events and wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_events(prof), wall_ms


def _busy_ms(events) -> float:
    """The union of the device intervals, in ms."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def _cuda_ops():
    """A dispatch mode that counts, by name, every PyTorch operation that
    takes or makes a CUDA tensor while it is active: the host's own record
    of the device work PyTorch issues (the hand kernels launch through
    ``ctypes`` and are not among them). Unlike the profiler's device
    events, which a window may lose whole (PERF.md §7), it drops nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class CudaOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_leaves((args, kwargs, out))):
                self.ops[str(func)] = self.ops.get(str(func), 0) + 1
            return out

    return CudaOps()


def megafleet_steps(eng, first: int, n: int) -> dict:
    """Chunks ``first .. first + 3n`` of a consensus engine on the card.
    Under ``torch.profiler``, ``n`` chunk steps of one launch each: device
    operations a step (kernels, copies, fills; each name's count over the
    steps, rounded, summed: the profiler may drop an event at a window's
    edge, the raw count is kept beside), the ``fleet_chunk`` kernel's
    device time a launch and the card's busy share of the window (the
    union of the device intervals over its wall time); then one launch of
    the next ``n`` chunks (a span), its device time a chunk and busy
    share; then one more span of ``n`` chunks between CUDA events. Each
    profiled window also records on the host the PyTorch operations on
    CUDA tensors (:func:`_cuda_ops`) and the kernel's launches
    (``_kernels.LAUNCHES``): the record the phase's checks read, since the
    profiler may lose a window's device events whole."""
    from p2pfl_tpu_torch.ops import _kernels

    def recorded(fn):
        ops = _cuda_ops()
        before = _kernels.LAUNCHES["fleet_chunk"]

        def run():
            with ops:
                fn()

        events, wall_ms = _profiled(run)
        return events, wall_ms, ops.ops, _kernels.LAUNCHES["fleet_chunk"] - before

    by_name: dict = {}
    events, wall_ms, ops, launched = recorded(lambda: [eng.step(s) for s in range(first, first + n)])
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    kern = [e.time_range.elapsed_us() / 1e3 for e in events if "fleet_chunk_kernel" in e.name]
    span_events, span_wall_ms, span_ops, span_launched = recorded(lambda: eng.step(first + n, n))
    span_by_name: dict = {}
    for e in span_events:
        span_by_name[e.name] = span_by_name.get(e.name, 0) + 1
    span_kern = [e.time_range.elapsed_us() / 1e3 for e in span_events if "fleet_chunk_kernel" in e.name]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    eng.step(first + 2 * n, n)
    end.record()
    end.synchronize()
    return {"chunk": eng.cfg.chunk, "steps": n, "device_ops_per_step": sum(round(c / n) for c in by_name.values()),
            "device_ops_by_name": by_name, "device_events_per_step_raw": len(events) / n,
            "torch_cuda_ops": ops, "launches": launched,
            "kernel_launches_seen": len(kern), "kernel_ms": statistics.median(kern) if kern else None,
            "window_ms_per_step": wall_ms / n, "busy_share": _busy_ms(events) / wall_ms if events else None,
            "span_ops_by_name": span_by_name, "span_torch_cuda_ops": span_ops, "span_launches": span_launched,
            "span_kernel_ms_per_chunk": sum(span_kern) / n if span_kern else None,
            "span_busy_share": _busy_ms(span_events) / span_wall_ms if span_events else None,
            "span_ms_per_chunk_events": start.elapsed_time(end) / n}


def megafleet_bound_bytes(eng, res) -> float:
    """The bytes a run's chunk steps must move, a chunk: each event's
    record read once (the grid columns the kernel reads, its client's
    sample), pass A's rows (the client row read and written, its target
    read), each admitted payload's window row and its weight, keys and
    sample written once, each regional fold's window read once and its
    params written, each global fold's window read and its row and mint
    written (the global rows pass A starts from are among those)."""
    cfg = eng.cfg
    dim = cfg.dim
    record = sum(t.element_size() for t in eng.ev.values()) + 4
    pass_a = 4 * (dim + 1) * 2 + 4 * dim
    insert = 4 * dim + 16
    rfold = cfg.k_reg_max * (4 * dim + 16) + 4 * dim
    gfold = cfg.k_global * (4 * dim + 12) + 4 * dim + 4
    return (res.n_events * (record + pass_a) + res.buffered * insert + res.regional_merges * rfold
            + res.merges * gfold) / max(eng.n_chunks, 1)


def megafleet_latency_bound(eng, res, lat: dict) -> dict:
    """The least time a chunk's dependent chain could take on this card,
    from its own latencies (``_kernels.fleet_latency_probe``, ns) and the
    run's counts: each event two dependent shared-memory loads (its
    regional, then that regional's counter) and one fp32 add (the rate
    gate's difference); each fedavg fold of K slots 3K dependent fp32
    operations (the key-order total's K adds, then a coordinate's K
    multiply-adds as two roundings each); each chunk three block
    barriers, one device-memory round trip (pass A's gather) and the
    binary search's ceil(log2(v_cap + 1)) dependent shared loads."""
    cfg = eng.cfg
    S = max(eng.n_chunks, 1)
    search = math.ceil(math.log2(cfg.v_cap + 1))
    terms = {
        "events_ns": res.n_events * (2 * lat["smem"] + lat["fadd"]),
        "folds_ns": (res.regional_merges * cfg.k_reg_max + res.merges * cfg.k_global) * 3 * lat["fadd"],
        "chunks_ns": S * (3 * lat["barrier"] + lat["dram"] + search * lat["smem"]),
    }
    total = sum(terms.values())
    return {"latency_bound_ms_per_chunk": total / S / 1e6, "latency_bound_s_run": total / 1e9,
            "terms_s": {k: v / 1e9 for k, v in terms.items()}, "latencies_ns": lat, "search_steps": search,
            "formula": "E(2 smem + fadd) + (F_r K_r + F_g K_g) 3 fadd + S(3 barrier + dram + ceil(log2(v_cap+1)) smem)"}


def megafleet_sections(eng, first: int, n: int, clock_ghz: float) -> dict:
    """The kernel's own section timing (``ChunkedFleet.prof``: thread 0's
    clock64 around each section) over one span launch of chunks ``first ..
    first + n`` of a consensus engine that stands at ``first`` (its
    argument table rebuilt with the timing buffer): µs a chunk in the
    records' staging, pass A, the events' chain and warp 0's part of the
    regional and global folds (staging a window, posting it), warp 1's
    busy time folding beside them, and the counts."""
    from p2pfl_tpu_torch.ops import _kernels

    eng.prof = torch.zeros(len(_kernels.FLEET_PROF), dtype=torch.int64, device="cuda")
    eng.kernel_args = None
    eng.step(first, n)
    vals = dict(zip(_kernels.FLEET_PROF, eng.prof.tolist()))
    chunks = max(vals["chunks"], 1)

    def us(k):
        return vals[k] / clock_ghz / 1e3

    warp0 = ("stage", "pass_a", "events", "regional_folds", "global_folds")
    return {"chunks": vals["chunks"], "us_per_chunk": {k: us(k) / chunks for k in warp0},
            "us_per_chunk_total": sum(us(k) for k in warp0) / chunks,
            "folder_busy_us_per_chunk": us("folder") / chunks,
            "regional_folds": vals["n_regional_folds"], "global_folds": vals["n_global_folds"],
            "folder_us_per_fold": us("folder") / max(vals["n_regional_folds"] + vals["n_global_folds"], 1),
            "warp0_us_per_regional_fold": us("regional_folds") / max(vals["n_regional_folds"], 1)}


def megafleet_against_twin(card, host, at: int, max_chunks: int = 4000) -> dict:
    """(d)'s kernel check at the main path's shapes: the 1M fleet's CPU
    copy (the plain twin) steps from the first chunk until a regional
    flush (hier) and a global flush have both happened, eight chunks past
    that and at least to ``at``, where the card engine (the kernel)
    stands; the card engine then steps to the same chunk. The twin's chunk
    times (passes B-D, after its pass A) from chunk 8 on. Then the carries
    as in (c): integer and time fields equal the twin's, params within
    ``MF_PARAM_TOL`` of the largest."""
    from p2pfl_tpu_torch.ops import fleet_kernels as fk

    i_merges, i_rmerges = fk.SCALARS.index("merges"), fk.SCALARS.index("rmerges")
    plain, s, flushed = [], 0, None
    while s < min(max_chunks, host.n_chunks):
        host.pass_a(s)
        t = time.perf_counter()
        fk.fleet_chunk_plain(host, s)
        if s >= 8:
            plain.append((time.perf_counter() - t) * 1e3)
        s += 1
        si = host.carry["si"]
        if flushed is None and si[i_merges] > 0 and (si[i_rmerges] > 0 or not host.cfg.hier):
            flushed = s
        if flushed is not None and s >= max(at, flushed + 8):
            break
    for c in range(at, s):
        card.step(c)
    exact, gap, scale = compare_carries(card, host)
    si = host.carry["si"].tolist()
    return {"chunks": s, "first_global_flush_by_chunk": flushed, "merges": si[i_merges],
            "regional_merges": si[i_rmerges], "params_max_abs_gap": gap, "params_max_abs": scale,
            "plain_ms": statistics.median(plain) if plain else None,
            "checks": {"a regional and a global flush in the compared chunks": flushed is not None,
                       "integers and times equal the twin's": exact,
                       f"params within {MF_PARAM_TOL:g} of the largest": gap <= MF_PARAM_TOL * max(scale, 1.0)}}


def megafleet_full() -> dict:
    """(d) the 1M-client fleet through ``MegaFleet.run`` on the card:
    wall seconds, clients/s, events/s, merges and regional merges beside
    BENCH_ASYNC.json's, time to 5 % of the start loss, the staleness mean,
    peak memory, the kernel's launches (the run is one span: one launch)
    and the final global model's sha256 (``megafleet_digest.py`` prints
    another tree's to compare with); then the same fleet's
    engine at 64 and 256 events a chunk (:func:`megafleet_steps`); the C
    256 engine is then held against its plain twin on a CPU copy
    (:func:`megafleet_against_twin`) and runs the rest of its chunks in
    one launch between CUDA events (the chunk loop's seconds, µs a
    chunk); the latency bound from the card's own latencies
    (:func:`megafleet_latency_bound`). ``init_s`` is ``MegaFleet``'s
    construction (the router over a million addresses), outside ``run``'s
    wall time as in JAX; peak memory is this phase's, above what earlier
    phases still hold."""
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, MegaFleet
    from p2pfl_tpu_torch.ops import _kernels

    cfg = MEGAFLEET
    spec = FleetSpec.synth(cfg["n"], seed=cfg["seed"], slow_frac=cfg["slow_frac"])
    start_loss = spec.loss(spec.init)

    def fleet(chunk):
        return MegaFleet(spec, cluster_size=cfg["cluster"], k=cfg["k"], updates_per_node=cfg["updates"],
                         local_lr=cfg["local_lr"], chunk=chunk, target_loss=0.05 * start_loss, device="cuda")

    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    mega, init_s = _timed_s(lambda: fleet(cfg["chunk"]))
    res, wall = _timed_s(mega.run)
    launches = _kernels.LAUNCHES["fleet_chunk"]
    hist = res.staleness_hist_edge
    tau_mean = sum(i * c for i, c in enumerate(hist)) / max(sum(hist), 1)
    losses = np.asarray([x[2] for x in res.loss_curve])
    mints = np.asarray([x[0] for x in res.loss_curve])
    out = {"clients": cfg["n"], "events": res.n_events, "wall_s": wall, "engine_wall_s": res.wall_s,
           "clients_per_s": cfg["n"] / wall, "events_per_s": res.n_events / wall, "merges": res.merges,
           "regional_merges": res.regional_merges, "bench_async_counts": MEGAFLEET_COUNTS,
           "time_to_target_virtual_s": res.time_to_target, "start_loss": start_loss,
           "final_loss": res.final_loss(), "staleness_mean": tau_mean,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() - held) / 1e9, "launches_fleet_chunk": launches,
           "final_global_sha256": hashlib.sha256(res.params["w"].cpu().numpy().tobytes()).hexdigest(),
           "init_s": init_s}
    out["checks"] = {
        "events, merges and regional merges equal BENCH_ASYNC.json's": (
            res.n_events, res.merges, res.regional_merges) == tuple(MEGAFLEET_COUNTS.values()),
        "one launch for the run (chunks / span rounded up, the span the whole run)": launches == 1,
        "version == merges, mint times monotone": res.version == res.merges and bool(np.all(np.diff(mints) >= 0)),
        "finite losses, 5 % of the start loss reached": bool(np.all(np.isfinite(losses)))
        and res.time_to_target is not None,
    }
    out["checks"]["final loss below the target"] = res.final_loss() <= 0.05 * start_loss
    # the chunk step at C 64 and C 256, each on an engine of its own; the
    # main chunk's engine build is the run's host preparation, timed alone.
    # After its measured steps the C 256 engine is held against its plain
    # twin on a CPU copy (the kernel at the main path's shapes), then runs
    # the rest of its chunks in one launch; it must end where
    # MegaFleet.run ended
    steps, first, n = {}, 8, 40
    for chunk in (64, cfg["chunk"]):
        eng, prep_s = _timed_s(lambda: fleet(chunk).chunked_engine())  # noqa: B023
        for s in range(first):  # warm-up (the first launch builds the table)
            eng.step(s)
        steps[chunk] = megafleet_steps(eng, first, n)
        if chunk == cfg["chunk"]:
            out["place"] = _kernels.fleet_chunk_place(eng.kernel_args)
            out["twin_1m"] = twin = megafleet_against_twin(eng, fleet(chunk).chunked_engine(device="cpu"),
                                                           first + 3 * n)
            bound_bytes = megafleet_bound_bytes(eng, res)
            probe = _kernels.fleet_latency_probe()
            out["sections"] = megafleet_sections(eng, twin["chunks"], 2000, probe["clock_ghz"])
            eng.prof, eng.kernel_args = None, None
            done = twin["chunks"] + 2000
            rest = eng.n_chunks - done
            _kernels.reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng.step(done, rest)
            end.record()
            torch.cuda.synchronize()
            rest_s = time.perf_counter() - t0
            span_ms = start.elapsed_time(end)
            end_state = eng.result()
            out.update({"host_prep_s": prep_s, "rest_chunks": rest, "rest_launches": _kernels.LAUNCHES["fleet_chunk"],
                        "loop_ms_per_chunk": rest_s / rest * 1e3, "loop_s_estimate": rest_s / rest * eng.n_chunks,
                        "kernel_us_per_chunk_events": span_ms / rest * 1e3,
                        "kernel_s_estimate": span_ms / rest * eng.n_chunks / 1e3})
            out["checks"]["the rest of the run in one launch"] = out["rest_launches"] == 1
            out["checks"]["the stepped engine ends where MegaFleet.run ended"] = (
                end_state["merges"] == res.merges and torch.equal(end_state["G"][res.version], res.params["w"]))
            out["latency"] = megafleet_latency_bound(eng, res, probe)
        del eng
    out["steps"] = steps
    # the host's record decides: in each chunk size's two windows no
    # PyTorch operation on a CUDA tensor, one kernel launch a step and one
    # a span. The profiler may lose a window's device events whole (PERF.md
    # §7: in a run of every phase it has lost the per-step windows, and
    # both); what device events it did record must be the kernel's alone
    host = {c: (r["torch_cuda_ops"], r["span_torch_cuda_ops"], r["launches"] / n, r["span_launches"])
            for c, r in steps.items()}
    seen = {c: set(r["device_ops_by_name"]) | set(r["span_ops_by_name"]) for c, r in steps.items()}
    out["profiler_recorded_device_events"] = {c: bool(names) for c, names in seen.items()}
    out["checks"]["device operations a step the same at C 64 and 256"] = (
        host[64] == host[cfg["chunk"]] and (not seen[64] or not seen[cfg["chunk"]] or seen[64] == seen[cfg["chunk"]]))
    out["checks"]["no device operation but the kernel in a chunk step (pass A inside)"] = all(
        h == ({}, {}, 1.0, 1) and all("fleet_chunk_kernel" in name for name in seen[c]) for c, h in host.items())
    out["checks"].update({f"1M against the twin: {k}": v for k, v in twin["checks"].items()})
    row = steps[cfg["chunk"]]
    out["kernel_row"] = {"ms": out["kernel_us_per_chunk_events"] / 1e3, "ms_per": "chunk (one launch of a span)",
                         "ms_profiler_span_per_chunk": row["span_kernel_ms_per_chunk"],
                         "ms_one_chunk_launch": row["kernel_ms"], "plain_ms": twin["plain_ms"],
                         "bound_ms": bound_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
                         "bound_bytes_per_chunk": bound_bytes,
                         "latency_bound_ms": out["latency"]["latency_bound_ms_per_chunk"], "library_ms": None}
    return out


def megafleet_autotune() -> dict:
    """(e) ``chunk="auto"`` on a 20k-client fleet of the same shape: the
    first run measures every candidate (two engine runs each) and writes
    the fleet-tune cache; a second fleet, with the in-process cache
    cleared, replays the winner from the file with no measurement."""
    from pathlib import Path

    from p2pfl_tpu_torch.federation import megafleet as mf
    from p2pfl_tpu_torch.ops import fleet_autotune as ft
    from p2pfl_tpu_torch.settings import Settings

    cfg = MEGAFLEET
    cache = Path("build") / "fleet_tune.json"
    cache.unlink(missing_ok=True)
    calls = []
    real = mf.MegaFleet._run_chunked

    def counted(self, *a):
        calls.append(a[0].chunk)
        return real(self, *a)

    spec = mf.FleetSpec.synth(20_000, seed=cfg["seed"], slow_frac=cfg["slow_frac"])
    old = Settings.FLEET_TUNE_CACHE
    Settings.FLEET_TUNE_CACHE = str(cache)
    mf.MegaFleet._run_chunked = counted
    try:
        ft.clear_memory_cache()
        runs = []
        for _ in range(2):
            mega = mf.MegaFleet(spec, cluster_size=cfg["cluster"], k=cfg["k"], updates_per_node=cfg["updates"],
                                local_lr=cfg["local_lr"], chunk="auto", device="cuda")
            res, wall = _timed_s(mega.run)
            runs.append({"chunk": mega.chunk, "engine_runs": len(calls), "wall_s": wall, "merges": res.merges})
            calls.clear()
            ft.clear_memory_cache()  # the replay reads the file
        entry = json.loads(cache.read_text()) if cache.exists() else {}
    finally:
        mf.MegaFleet._run_chunked = real
        Settings.FLEET_TUNE_CACHE = old
        ft.clear_memory_cache()
    key = next(iter(entry), "")
    n_cands = len(ft.DEFAULT_CANDIDATES)
    return {"runs": runs, "cache_key": key, "timings_s": entry.get(key, {}).get("timings"), "checks": {
        f"first run measured {n_cands} candidates twice, then ran": runs[0]["engine_runs"] == 2 * n_cands + 1,
        "replay ran once, no measurement": runs[1]["engine_runs"] == 1,
        "replay took the cached winner": runs[1]["chunk"] == runs[0]["chunk"] == entry.get(key, {}).get("chunk"),
        "cache keyed by the card": key.startswith(torch.cuda.get_device_name(0)),
        "same merges": runs[0]["merges"] == runs[1]["merges"] > 0,
    }}


def drive_megafleet() -> tuple[bool, dict]:
    """The megafleet engine on the card, parts (a)-(e) (see the module
    docs); each part fails the phase on its own."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.settings import set_test_settings

    set_test_settings()  # the JAX tests' knobs: 48 events a chunk unless a part says otherwise
    ok = True
    out: dict = {}

    def part(tag: str, row: dict) -> None:
        nonlocal ok
        checks = row.get("checks", {})
        good = all(checks.values())
        ok &= good
        log(f"[megafleet] {tag}: {json.dumps(row, default=str)} {'OK' if good else 'FAIL'}")

    for cluster in (0, 32):
        out[f"pair_{cluster}"] = row = megafleet_pair(cluster)
        part(f"(a) 1k pair, clusters of {cluster or 'all (flat)'}", row)
    out["engines"] = megafleet_engines()
    for name, row in out["engines"].items():
        part(f"(b) chunked against per-event, {name}", row)
    _kernels.reset_launches()
    out["twin"] = megafleet_kernel_vs_twin()
    for name, row in out["twin"]["cases"].items():
        part(f"(c) kernel against twin, {name}", row)
    out["full"] = full = megafleet_full()
    part("(d) 1M clients", {k: v for k, v in full.items() if k != "kernel_row"})
    log(f"[megafleet] (d) {full['wall_s']:.2f} s wall, {full['clients_per_s']:.0f} clients/s, "
        f"{full['events_per_s']:.0f} events/s, merges {full['merges']} (BENCH_ASYNC.json "
        f"{MEGAFLEET_COUNTS['merges']}), regional merges {full['regional_merges']} "
        f"({MEGAFLEET_COUNTS['regional_merges']}), device ops a step "
        f"{ {c: r['device_ops_per_step'] for c, r in full['steps'].items()} }, kernel "
        f"{full['kernel_row']['ms'] * 1e3:.2f} us a chunk in a span (one-chunk launch "
        f"{full['kernel_row']['ms_one_chunk_launch']}; chunk loop {full['loop_s_estimate']:.3f} s; plain twin "
        f"{full['kernel_row']['plain_ms']:.3f} ms; bounds {full['kernel_row']['bound_ms']:.6f} ms bytes, "
        f"{full['kernel_row']['latency_bound_ms']:.5f} ms latency), final G sha256 {full['final_global_sha256']}")
    out["autotune"] = megafleet_autotune()
    part("(e) chunk='auto' and its replay", out["autotune"])
    out["kernel_row"] = dict(full["kernel_row"],
                             max_abs_err=max(out["twin"]["max_abs_err"], full["twin_1m"]["params_max_abs_gap"]),
                             launches=full["launches_fleet_chunk"])
    return ok, out


# ---- phase 9b: sharded nodes ----


#: part (a): config 5 full-parameter at full width and depth, 2 nodes x 4
#: slots of the card, 2 sequences a node in batches of 1 (2 steps a round)
SHARDED = dict(nodes=2, model_parallel=4, seq=1024, per_node=2, batch=1, timed_rounds=2, lr=1e-4)
SHARDED_CFG = dict(vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=22, ffn_hidden=5632, lora_rank=0)
#: a slot holds at most the full params + Adam / model_parallel times this
#: (the replicated norms)
SHARDED_SLOT_SLACK = 1.2


def _sharded_fed(model_parallel: int, bwd_mode: str):
    """(config, federation) of part (a); the dense init it was placed
    from is dropped (the federation holds the nodes' slot shards)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
    from p2pfl_tpu_torch.parallel import ShardedNodeFederation

    cfg = TransformerConfig(**SHARDED_CFG, flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode))
    n = SHARDED["nodes"]
    data = FederatedDataset.synthetic_lm(vocab_size=cfg.vocab_size, seq_len=SHARDED["seq"],
                                         n_train=n * SHARDED["per_node"], n_test=n, seed=7)
    model = tiny_transformer(seq_len=SHARDED["seq"], seed=0, cfg=cfg, attn="flash")
    fed = ShardedNodeFederation.from_dataset(
        model, data, n_nodes=n, model_parallel=model_parallel, batch_size=SHARDED["batch"], vote=False, seed=3,
        learning_rate=SHARDED["lr"],
    )
    return cfg, fed


def sharded_federation(results: dict) -> tuple[bool, dict]:
    """Part (a): the timed rounds, the per-slot bytes, kernel 9 on a
    sharded tree, and the split-backward bit-equality of m 4 against m 1."""
    from p2pfl_tpu_torch.learning.learner import adam
    from p2pfl_tpu_torch.models.transformer import init_params
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves
    from p2pfl_tpu_torch.parallel.ici_plane import _blocks, exchange_plain
    from p2pfl_tpu_torch.parallel.sharding import gather_tree, shard_bytes_accounting

    n, mp, depth = SHARDED["nodes"], SHARDED["model_parallel"], SHARDED_CFG["n_layers"]
    flash = ("flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, fed = _sharded_fed(mp, "auto")
    steps = fed._nb
    # per-slot resident params + Adam against the shard_shape accounting
    meta = init_params(cfg, device="meta")
    acct = shard_bytes_accounting(fed.slices[0], meta) + shard_bytes_accounting(fed.slices[0], adam().init(meta))
    full = sum(x.numel() * 4 for x in tree_leaves(meta)) * 3  # fp32 params, mu, nu
    fed.model.params = meta  # the dense init: the nodes hold their slot shards
    torch.cuda.empty_cache()
    per_slot = fed.per_device_bytes()
    ok = len(per_slot) == n * mp and set(per_slot.values()) == {acct} and acct <= full / mp * SHARDED_SLOT_SLACK

    _kernels.reset_launches()
    t0 = time.perf_counter()
    secs, losses = [], []
    for _ in range(SHARDED["timed_rounds"]):
        t = time.perf_counter()
        entry = fed.run_round(epochs=1)  # reads the loss back: the round has ended
        secs.append(time.perf_counter() - t)
        losses.append(entry["train_loss"])
    torch.cuda.synchronize()
    launches_fused = {k: _kernels.LAUNCHES[k] for k in flash}
    implied = SHARDED["timed_rounds"] * n * steps * depth
    ok &= launches_fused == {"flash_fwd": implied, "flash_bwd_dkvq": implied, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    ok &= all(math.isfinite(x) for x in losses)
    # the fold's inputs were slot-shard stacks (the federation checks it
    # every round) and the diffused params are slot shards
    wq = fed.node_params(0)["layer_0"]["attn"]["wq"]["kernel"]
    ok &= [tuple(s.shape) for s in wq.shards] == [(cfg.dim, cfg.dim // mp)] * mp
    peak = torch.cuda.max_memory_allocated()
    # kernel 9 on node 0's slot blocks (its whole params), as phase exchange times trees
    srcs = [b for _, leaf in tree_items(fed.params[0]) for b in _blocks(leaf)]
    dsts, refs = [torch.empty_like(x) for x in srcs], [torch.empty_like(x) for x in srcs]
    _kernels.ici_exchange(srcs, dsts)
    exchange_plain(srcs, refs)
    torch.cuda.synchronize()
    exact = all(bits_equal(d, r) for d, r in zip(dsts, refs))
    err = max((d.float() - r.float()).abs().max().item() for d, r in zip(dsts, refs))
    n_bytes = sum(x.numel() * x.element_size() for x in srcs)
    bms, by = bound(2 * n_bytes, 0)
    row = dict(blocks=len(srcs), bytes=n_bytes, max_abs_err=err,
               ms=time_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
               plain_ms=time_ms(lambda: exchange_plain(srcs, refs)), bound_ms=bms, bound_by=by,
               library_ms=time_ms(lambda: torch._foreach_copy_(refs, srcs)))
    row.update(device_times(lambda: _kernels.ici_exchange(srcs, dsts), lambda: torch._foreach_copy_(refs, srcs)))
    ok &= exact and err == 0.0
    results["sharded_tree"] = row
    del srcs, dsts, refs, wq
    metrics = fed.evaluate()
    ok &= math.isfinite(metrics["test_loss"])
    summary = {
        "nodes": n, "model_parallel": mp, "layers": depth, "steps_per_round": steps,
        "s_round": secs, "train_losses": losses, "test_loss": metrics["test_loss"],
        "per_slot_bytes": acct, "per_slot_bytes_measured": sorted(set(per_slot.values())),
        "full_params_adam_bytes": full, "per_slot_share": acct / full, "peak_mem_gb": peak / 1e9,
        "launches_fused": launches_fused, "launches_implied": implied,
    }
    log(f"[sharded] (a) {n} nodes x model_parallel {mp} on {n * mp} slots of cuda:0, {depth}L full-parameter, "
        f"{steps} steps a round: s/round {secs}, per-slot params + Adam {acct} bytes (accounting {acct}, "
        f"{acct / full:.4f} of the full {full}), peak {peak / 1e9:.2f} GB, kernel launches {launches_fused} "
        f"(implied {implied} each of 1-2); kernel 9 on node 0's {row['blocks']} slot blocks bit-exact {exact}: "
        f"{json.dumps(row)} {'OK' if ok else 'FAIL'}")
    del fed
    torch.cuda.empty_cache()

    # split backward (deterministic): m 4 against m 1, one round each
    outs, split_counts = {}, {}
    for m in (mp, 1):
        _, f = _sharded_fed(m, "split")
        f.model.params = meta
        torch.cuda.empty_cache()
        _kernels.reset_launches()
        f.run_round(epochs=1)
        torch.cuda.synchronize()
        split_counts[m] = {k: _kernels.LAUNCHES[k] for k in flash}
        one = n * f._nb * depth
        ok &= split_counts[m] == {"flash_fwd": one, "flash_bwd_dkvq": 0, "flash_bwd_dq": one, "flash_bwd_dkv": one}
        nodes = [tree_leaves(gather_tree(f.node_params(i))) for i in range(n)]
        ok &= all(torch.equal(a, b) for a, b in zip(nodes[0], nodes[1]))
        outs[m] = [x.cpu() for x in nodes[0]]
        del f, nodes
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(outs[mp], outs[1]))
    gap = max((a - b).abs().max().item() for a, b in zip(outs[mp], outs[1]))
    ok &= same
    summary.update(split_bit_equal=same, split_gap=gap, launches_split=split_counts[mp], launches_split_m1=split_counts[1])
    log(f"[sharded] (a) split backward, one round at model_parallel {mp} against 1 from seed 3: bit-equal {same} "
        f"(max gap {gap:.3e}); launches {split_counts} {'OK' if ok else 'FAIL'}")
    return ok, summary


def sharded_gossip() -> tuple[bool, dict]:
    """Part (b): two gossip Nodes on (1, 2) slices of ``cuda:0``, ICI plane;
    every exchange's destinations are compared, after the run, with the
    plain version's copy of the same sources (no host read inside a
    Node's thread)."""
    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.examples import mnist as example
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel import ici_plane
    from p2pfl_tpu_torch.parallel.sharding import SlotSharded, gather_tree
    from p2pfl_tpu_torch.settings import set_test_settings

    set_test_settings()
    logger.set_level("WARNING")
    kw = dict(nodes=2, rounds=2, epochs=1, samples=8192, batch_size=128, device="cuda", topology="full",
              weights_plane="ici")
    real, records = ici_plane.exchange, []

    def spy(srcs, dsts):
        real(srcs, dsts)
        want = [torch.empty_like(d) for d in dsts]
        ici_plane.exchange_plain(srcs, want)
        records.append((list(dsts), want))

    def drive(model_parallel: int) -> dict:
        ici_mod.reset_ici_stats()
        logger.reset_comm_metrics()
        records.clear()
        _kernels.reset_launches()
        ici_plane.exchange = spy
        try:
            t = time.perf_counter()
            out = example.run(model_parallel=model_parallel, **kw)
            wall = time.perf_counter() - t
        finally:
            ici_plane.exchange = real
        torch.cuda.synchronize()
        comm = logger.get_comm_metrics()
        return {
            "params": out["params"], "wall_s": wall, "stats": ici_mod.ici_stats(),
            "launches_ici_exchange": _kernels.LAUNCHES["ici_exchange"], "exchanges": len(records),
            "blocks": sum(len(d) for d, _ in records),
            "blocks_exact": all(bits_equal(a, b) for d, w in records for a, b in zip(d, w)),
            "degraded": sum(c.get("fused_round_degraded", 0) for c in comm.values()),
            "captures": sum(c.get("fused_graph_capture", 0) for c in comm.values()),
        }

    runs = {m: drive(m) for m in (2, 1)}
    sharded, one = runs[2], runs[1]
    placed = isinstance(sharded["params"][0]["Dense_0"]["kernel"], SlotSharded)
    final = [tree_leaves(gather_tree(p)) for p in sharded["params"]]
    ref = [tree_leaves(gather_tree(p)) for p in one["params"]]
    equal_nodes = all(torch.equal(a, b) for a, b in zip(final[0], final[1]))
    equal_one_slot = all(torch.equal(a, b) for a, b in zip(final[0], ref[0]))
    gap = max((a.float() - b.float()).abs().max().item() for a, b in zip(final[0], ref[0]))
    st = sharded["stats"]
    ok = placed and equal_nodes and equal_one_slot
    for r in (sharded, one):
        ok &= r["launches_ici_exchange"] == r["stats"]["shard_sends"] == r["exchanges"] > 0
        ok &= r["stats"]["fallback_bytes"] == 0 and r["stats"]["align_violations"] == 0
        ok &= r["blocks_exact"] and r["degraded"] == 0
    summary = {m: {k: v for k, v in r.items() if k != "params"} for m, r in runs.items()}
    summary.update(bit_equal_one_slot=equal_one_slot, gap_one_slot=gap, launches_ici_exchange=sharded[
        "launches_ici_exchange"])
    log(f"[sharded] (b) 2 gossip Nodes on (1, 2) slices of cuda:0, ICI plane: kernel 9 launches "
        f"{sharded['launches_ici_exchange']} = shard sends {st['shard_sends']} = exchanges {sharded['exchanges']} "
        f"({sharded['blocks']} slot blocks, each bit-equal to exchange_plain: {sharded['blocks_exact']}), "
        f"fallbacks {st['fallback_bytes']}, bytes moved {st['bytes_moved']}, degraded rounds {sharded['degraded']}, "
        f"captures {sharded['captures']}; nodes equal {equal_nodes}; final model against one-slot learners "
        f"bit-equal {equal_one_slot} (max gap {gap:.3e}); wall {sharded['wall_s']:.2f} s (one-slot "
        f"{one['wall_s']:.2f}) {'OK' if ok else 'FAIL'}")
    return ok, summary


def drive_sharded() -> tuple[bool, dict]:
    import gc

    # part (a) peaks near 70 GB: what earlier phases left unreferenced goes first
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sharded] card memory allocated before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    results: dict = {}
    good_a, fed = sharded_federation(results)
    good_b, nodes = sharded_gossip()
    return good_a and good_b, {"federation": fed, "nodes": nodes, "exchange": results}


# ---- [meshes] the SPMD federations' meshes and GPipe (every slot on the card) ----

#: config 10's GPipe row at its stated size (``bench_suite.py:1847-1960``):
#: 2 nodes, 4 stages, 4L/128d, 8 heads, kv 8, ffn 344, vocab 512, seq 128,
#: batch 32 in 16 microbatches, seed 3, 512 sequences a node; bf16 on the
#: card (the row's f32 is its CPU stand-in)
GPIPE10 = dict(nodes=2, stages=4, n_micro=16, batch=32, seed=3, per_node=512, n_test=256, rounds=2,
               cfg=dict(vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=8, ffn_hidden=344, lora_rank=0))
#: the curve to 0.60 (``gpipe_target``): at most 10 rounds, at least 5
GPIPE10_TARGET = dict(target=0.60, max_rounds=10, min_rounds=5)
#: config 5 full-parameter (``SHARDED_CFG``) in 2 stages of 11 layers,
#: batch 2 in 2 microbatches, flash at seq 1024
GPIPE5 = dict(stages=2, batch=2, n_micro=2, seq=1024)
#: pipelined against monolithic value-and-grad in bf16: the grads'
#: relative L2 (the weight gradients sum the microbatches in another order;
#: 8.7e-4 at (a), 0.0113-0.0116 at (b) on an H100) and the loss's relative
#: gap (0 in every run of (a) and (b): a sequence's forward does not
#: depend on the batch it sits in)
GPIPE_GRAD_RTOL = 2e-2
GPIPE_LOSS_RTOL = 0.0
#: config 10's MoE row (``bench_suite.py:1776-1790``): 8 nodes, 4L/128d, 8
#: experts top-2, vocab 512, seq 128, batch 16, seed 3, 256 sequences a
#: node; expert_parallel 2 on a (4, 2) mesh of the card
EP10 = dict(nodes=8, rows=4, ep=2, batch=16, seed=3, per_node=256, n_test=512, rounds=2,
            cfg=dict(vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=8, ffn_hidden=256, lora_rank=0,
                     n_experts=8, moe_top_k=2))
#: ``main``'s LoRA federation on a (4, 4) mesh, the base split over the model axis
LORA_TP = dict(rows=4, model=4)
#: ``bench.py``'s 64 MLP nodes over 8 slots; a fused span of 2 rounds (the
#: 8-slot span's capture costs about a second a round)
MNIST_MESH = dict(slots=8, timed=2, span=2)


def _free_card() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _tree_bits_equal(a, b) -> bool:
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(bits_equal(x, y) for x, y in zip(la, lb))


def _lm_value_and_grad(params: dict, logits_and_aux, x, y) -> tuple:
    """(loss, grads) of ``CE(logits) + aux`` with ``logits_and_aux(params,
    x)`` the forward: the step both GPipe parts time and compare."""
    from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
    from p2pfl_tpu_torch.ops.tree import tree_items, tree_unflatten

    paths = [p for p, _ in tree_items(params)]
    leaves = [v.detach().requires_grad_(True) for _, v in tree_items(params)]
    with torch.enable_grad():
        logits, aux = logits_and_aux(tree_unflatten(dict(zip(paths, leaves))), x)
        loss = softmax_cross_entropy(logits, y).mean() + aux
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(dict(zip(paths, grads)))


def _pipe_against_mono(model, mesh, n_micro: int, x, y, iters: int = 3) -> dict:
    """One pipelined value-and-grad step against the monolithic one on the
    same batch: the loss gap, the grads' relative L2, each step's median ms
    (CUDA-synchronized host clock) and the launches of kernels 1 and 2 in
    one step of each."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel.pipeline import pipelined_lm_apply

    cfg = model.extra["config"]
    attn_fn = model.module.attn_fn

    def pipe(p, xb):
        return pipelined_lm_apply(p, xb, cfg, mesh, mesh.axis_names[0], n_micro=n_micro, attn_fn=attn_fn,
                                  return_aux=True)

    def mono(p, xb):
        return model.module.forward_with_aux(p, xb)

    out = {}
    for name, fn in (("pipe", pipe), ("mono", mono)):
        _kernels.reset_launches()
        loss, grads = _lm_value_and_grad(model.params, fn, x, y)
        torch.cuda.synchronize()
        launches = {k: _kernels.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv")}
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _lm_value_and_grad(model.params, fn, x, y)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        out[name] = (loss, grads, sorted(ts)[len(ts) // 2] * 1e3, launches)
        del grads
    (lp, gp, tp, kp), (lm, gm, tm, km) = out["pipe"], out["mono"]
    return {"loss_pipe": float(lp), "loss_mono": float(lm), "loss_rel_gap": abs(float(lp) - float(lm)) / abs(float(lm)),
            "grad_rel_l2": _rel_l2(tree_leaves(gm), tree_leaves(gp)), "pipe_ms": tp, "mono_ms": tm, "pipe_tax": tp / tm,
            "launches_pipe": kp, "launches_mono": km}


def _gpipe10_fed():
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.pipeline import pipeline_mesh
    from p2pfl_tpu_torch.parallel.spmd_lm import PipelineFederation

    g = GPIPE10
    model = tiny_transformer(seq_len=128, cfg=TransformerConfig(**g["cfg"]))
    data = FederatedDataset.synthetic_lm(vocab_size=512, n_train=g["nodes"] * g["per_node"], n_test=g["n_test"])
    shards = [data.partition(i, g["nodes"]) for i in range(g["nodes"])]
    mesh = pipeline_mesh(g["stages"], devices=["cuda:0"] * g["stages"])
    fed = PipelineFederation(model, shards, mesh=mesh, batch_size=g["batch"], n_micro=g["n_micro"], seed=g["seed"])
    return model, shards, fed


def meshes_gpipe10() -> tuple[bool, dict]:
    """(a) config 10's GPipe row: two profiled rounds (accuracy, s/round,
    the per-node epoch and FedAvg seconds), then one pipelined step
    against the monolithic one (the pipe tax). Seq 128 takes dense
    attention: no hand kernel launches."""
    from p2pfl_tpu_torch.ops import _kernels

    _free_card()
    _kernels.reset_launches()
    model, shards, fed = _gpipe10_fed()
    rounds = []
    for _ in range(GPIPE10["rounds"]):
        t = time.perf_counter()
        entry = fed.run_round(profile=True)
        s = time.perf_counter() - t
        rounds.append({"train_loss": entry["train_loss"], "s_round": s, "profile": fed.last_profile,
                       "test_acc": fed.evaluate()["test_acc"]})
    hand = sum(_kernels.LAUNCHES.values())
    b = GPIPE10["batch"]
    x = torch.from_numpy(shards[0].x_train[:b]).cuda()
    y = torch.from_numpy(shards[0].y_train[:b]).cuda()
    tax = _pipe_against_mono(model, fed.mesh, GPIPE10["n_micro"], x, y)
    hand += sum(tax["launches_pipe"].values()) + sum(tax["launches_mono"].values())
    checks = {
        "losses and accuracies finite": all(math.isfinite(r["train_loss"]) and 0 <= r["test_acc"] <= 1 for r in rounds),
        "profile filled on every profiled round": all(len(r["profile"]["node_epoch_s"]) == GPIPE10["nodes"] for r in rounds),
        f"grads' relative L2 <= {GPIPE_GRAD_RTOL}": tax["grad_rel_l2"] <= GPIPE_GRAD_RTOL,
        f"loss relative gap <= {GPIPE_LOSS_RTOL}": tax["loss_rel_gap"] <= GPIPE_LOSS_RTOL,
        "no hand kernel launched (dense attention)": hand == 0,
    }
    steps = GPIPE10["per_node"] // GPIPE10["batch"]
    out = {"rounds": rounds, "pipe_vs_mono": tax, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "captured_step_ms": 1e3 * sum(rounds[-1]["profile"]["node_epoch_s"]) / (GPIPE10["nodes"] * steps),
           "checks": checks}
    del fed, model
    return all(checks.values()), out


def meshes_gpipe5() -> tuple[bool, dict]:
    """(b) GPipe at config 5's full width with flash: 2 stages of 11
    layers, batch 2 in 2 microbatches; one pipelined value-and-grad step
    against the monolithic one. Kernels 1 and 2 launch once a layer a
    microbatch: 44 for the pipelined step, 22 for the monolithic one."""
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.pipeline import pipeline_mesh

    _free_card()
    g = GPIPE5
    cfg = TransformerConfig(**SHARDED_CFG)
    model = tiny_transformer(seq_len=g["seq"], seed=0, cfg=cfg, attn="flash")
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (g["batch"], g["seq"] + 1), device="cuda", generator=gen)
    mesh = pipeline_mesh(g["stages"], devices=["cuda:0"] * g["stages"])
    tax = _pipe_against_mono(model, mesh, g["n_micro"], tokens[:, :-1], tokens[:, 1:], iters=2)
    layers = cfg.n_layers
    want_pipe = {"flash_fwd": layers * g["n_micro"], "flash_bwd_dkvq": layers * g["n_micro"]}
    want_mono = {"flash_fwd": layers, "flash_bwd_dkvq": layers}
    checks = {
        f"grads' relative L2 <= {GPIPE_GRAD_RTOL}": tax["grad_rel_l2"] <= GPIPE_GRAD_RTOL,
        f"loss relative gap <= {GPIPE_LOSS_RTOL}": tax["loss_rel_gap"] <= GPIPE_LOSS_RTOL,
        f"kernels 1, 2 at {want_pipe['flash_fwd']} pipelined": all(tax["launches_pipe"][k] == n for k, n in want_pipe.items()),
        f"kernels 1, 2 at {layers} monolithic": all(tax["launches_mono"][k] == n for k, n in want_mono.items()),
    }
    out = {"layers": layers, "params": model.param_count, **tax,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "checks": checks}
    del model
    return all(checks.values()), out


def _expert_bytes(tree, mesh) -> tuple[dict, int]:
    """Each slot's bytes of the expert stacks (``mlp/w[123]``) of a
    node-stacked tree, and one slot's by ``SlotSharding.shard_shape``."""
    import re

    from p2pfl_tpu_torch.parallel.sharding import named_paths, slot_bytes

    experts = {p: x for p, x in named_paths(tree) if re.search(r"mlp/w[123]$", p)}
    per_slot = slot_bytes(experts, mesh=mesh)
    want = sum(math.prod(x.sharding.shard_shape(tuple(x.shape))) * x.element_size() for x in experts.values())
    return per_slot, want


def meshes_ep10() -> tuple[bool, dict]:
    """(c) expert parallelism on config 10's MoE row: 8 nodes on a (4, 2)
    mesh, half the experts a slot; two rounds against expert_parallel 1 on
    the same nodes axis (a (4, 1) mesh): params and losses bit-equal."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd_lm import SpmdLmFederation

    _free_card()
    g = EP10
    cfg = TransformerConfig(**g["cfg"])
    data = FederatedDataset.synthetic_lm(vocab_size=512, n_train=g["nodes"] * g["per_node"], n_test=g["n_test"])
    runs = {}
    for ep in (g["ep"], 1):
        model = tiny_transformer(seq_len=128, cfg=cfg)
        mesh = federation_mesh(g["rows"], model_parallel=ep, devices=["cuda:0"] * (g["rows"] * ep))
        fed = SpmdLmFederation.from_dataset(model, data, n_nodes=g["nodes"], batch_size=g["batch"], vote=False,
                                            seed=g["seed"], mesh=mesh, expert_parallel=ep)
        per_slot, want = _expert_bytes(fed.params, mesh)
        losses, secs = [], []
        for _ in range(g["rounds"]):
            t = time.perf_counter()
            losses.append(float(fed.run_round()["train_loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        runs[ep] = {"fed": fed, "losses": losses, "s_round": secs, "slot_expert_bytes": sorted(set(per_slot.values())),
                    "accounting": want, "test_acc": fed.evaluate()["test_acc"]}
    a, b = runs[g["ep"]], runs[1]
    full_experts = b["accounting"]  # one slot of a (4, 1) mesh holds its nodes' whole stacks
    checks = {
        "every slot's expert bytes equal the shard_shape accounting": a["slot_expert_bytes"] == [a["accounting"]],
        "half the experts a slot": a["accounting"] * g["ep"] == full_experts,
        "params bit-equal to expert_parallel 1": all(
            _tree_bits_equal(a["fed"].node_params(i), b["fed"].node_params(i)) for i in range(g["nodes"])),
        "losses bit-equal": a["losses"] == b["losses"],
        "losses finite": all(math.isfinite(x) for x in a["losses"]),
    }
    out = {ep: {k: v for k, v in r.items() if k != "fed"} for ep, r in runs.items()}
    out.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, checks=checks)
    del runs, a, b
    return all(checks.values()), out


def meshes_lora_tp() -> tuple[bool, dict]:
    """(d) ``main``'s LoRA federation on a (4, 4) mesh with the frozen base
    split over the model axis: each slot's base bytes against the
    accounting, one split-backward round bit-equal to the replicated base
    on the same mesh. Each row of one node launches kernels 1, 3 and 4 once
    a layer a step."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_map
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.sharding import shard_bytes_accounting, slot_bytes
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    _free_card()
    g = LORA_TP
    cfg, data, model = _main_model("split")
    mesh = federation_mesh(g["rows"], model_parallel=g["model"], devices=["cuda:0"] * (g["rows"] * g["model"]))
    runs = {}
    for mp in (True, False):
        fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=MAIN["nodes"], batch_size=1, vote=False, seed=3,
                                              mesh=mesh, model_parallel_base=mp)
        base_bytes = sorted(set(slot_bytes(fed.base, mesh=mesh).values()))
        meta = tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"), fed.base)
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(fed.run_round()["train_loss"])
        torch.cuda.synchronize()
        runs[mp] = {"fed": fed, "loss": loss, "s_round": time.perf_counter() - t, "slot_base_bytes": base_bytes,
                    "accounting": shard_bytes_accounting(mesh, meta),
                    "launches": {k: _kernels.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}
    a, b = runs[True], runs[False]
    steps = a["fed"]._nb
    want = g["rows"] * steps * cfg.n_layers
    checks = {
        "every slot's base bytes equal the accounting": a["slot_base_bytes"] == [a["accounting"]],
        f"a slot of the split base holds at most 1/{g['model']} of the whole + 1 %":
            a["slot_base_bytes"][0] <= (1 / g["model"] + 0.01) * b["slot_base_bytes"][0],
        "round bit-equal to the replicated base": a["loss"] == b["loss"] and all(
            _tree_bits_equal(a["fed"].node_params(i), b["fed"].node_params(i)) for i in range(MAIN["nodes"])),
        f"kernels 1, 3, 4 at {want} (rows x steps x layers)": all(n == want for n in a["launches"].values()),
        "loss finite": math.isfinite(a["loss"]),
    }
    out = {("split_base" if mp else "replicated_base"): {k: v for k, v in r.items() if k != "fed"}
           for mp, r in runs.items()}
    out.update(steps=steps, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, checks=checks)
    del runs, a, b, model
    return all(checks.values()), out


def meshes_mnist() -> tuple[bool, dict]:
    """(e) ``bench.py``'s 64 MLP nodes over 8 slots of the card against
    the one-slot federation: one ``run_round`` and one ``run_fused`` span
    each, then timed rounds. Params and losses bit-equal (the fold sums
    node by node; the vmapped GEMMs gave 8 and 64 nodes the same bits in
    every run)."""
    from p2pfl_tpu_torch.examples import bench_mnist
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    _free_card()
    data = FederatedDataset.mnist(None, **bench_mnist.HARD_TASK)
    k = MNIST_MESH["slots"]
    runs = {}
    for slots in (1, k):
        mesh = federation_mesh(slots, devices=["cuda:0"] * slots)
        fed = SpmdFederation.from_dataset(
            mlp(), data, n_nodes=bench_mnist.N_NODES, batch_size=bench_mnist.BATCH, vote=False, seed=3,
            keep_opt_state=True, mesh=mesh,
        )
        first = fed.run_round(eval=True)
        after_round = fed.node_params(0)
        t = time.perf_counter()
        span = fed.run_fused(MNIST_MESH["span"], eval=True)  # captured, then replayed once
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
        secs = []
        for _ in range(MNIST_MESH["timed"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fed.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        t = time.perf_counter()
        fed.run_fused(MNIST_MESH["span"], eval=True)  # the captured span replayed
        torch.cuda.synchronize()
        runs[slots] = {"fed": fed, "after_round": after_round, "span_losses": [float(e["train_loss"]) for e in span],
                       "first_loss": float(first["train_loss"]), "first_acc": float(first["test_acc"]),
                       "s_round_eager": secs, "span_capture_s": capture_s,
                       "s_round_replayed": (time.perf_counter() - t) / MNIST_MESH["span"]}
    one, many = runs[1], runs[k]
    round_gap = _gaps([tree_leaves(one["after_round"])], [tree_leaves(many["after_round"])])
    final_gap = _gaps([tree_leaves(one["fed"].node_params(0))], [tree_leaves(many["fed"].node_params(0))])
    bits = round_gap == (0.0, 0.0) and final_gap == (0.0, 0.0)
    checks = {
        "round and span params bit-equal to one slot": bits,
        "span losses bit-equal": one["span_losses"] == many["span_losses"],
        "losses finite": all(math.isfinite(x) for x in many["span_losses"]),
    }
    out = {slots: {k_: v for k_, v in r.items() if k_ not in ("fed", "after_round")} for slots, r in runs.items()}
    out.update(bit_equal=bits, round_gap=round_gap, final_gap=final_gap,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, checks=checks)
    del runs, one, many
    return all(checks.values()), out


def drive_meshes() -> tuple[bool, dict]:
    """The SPMD federations' meshes and GPipe on slots of one card: (a)
    config 10's GPipe row, (b) GPipe at config 5's width with flash, (c)
    expert parallelism on config 10's MoE row, (d) ``main``'s LoRA
    federation with the base split, (e) ``bench.py``'s federation over a
    nodes axis of 8 slots."""
    log(f"[meshes] card memory allocated before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ok, out = True, {}
    for part, fn in (("gpipe10", meshes_gpipe10), ("gpipe5", meshes_gpipe5), ("ep10", meshes_ep10),
                     ("lora_tp", meshes_lora_tp), ("mnist", meshes_mnist)):
        t = time.perf_counter()
        good, res = fn()
        res["s"] = time.perf_counter() - t
        log(f"[meshes] ({part}) {json.dumps(res, default=str)} {'OK' if good else 'FAIL'}")
        ok &= good
        out[part] = res
    _free_card()
    return ok, out


def drive_gpipe_target() -> tuple[bool, dict]:
    """Config 10's GPipe row to 0.60 next-token accuracy: profiled rounds
    until the target, at least 5 and at most 10 (``bench_suite.py``'s
    loop), then two unprofiled rounds for s/round."""
    _free_card()
    _, _, fed = _gpipe10_fed()
    t0 = time.perf_counter()
    curve, reached, time_to = [], None, None
    for r in range(GPIPE10_TARGET["max_rounds"]):
        fed.run_round(profile=True)
        curve.append(fed.evaluate()["test_acc"])
        if reached is None and curve[-1] >= GPIPE10_TARGET["target"]:
            reached, time_to = r + 1, time.perf_counter() - t0
        if reached is not None and r + 1 >= GPIPE10_TARGET["min_rounds"]:
            break
    profile = fed.last_profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2):
        fed.run_round()
    torch.cuda.synchronize()
    out = {"curve": curve, "rounds_to_target": reached, "time_to_target_s": time_to,
           "s_round": (time.perf_counter() - t) / 2, "profile": profile}
    ok = reached is not None
    log(f"[gpipe_target] {json.dumps(out)} {'OK' if ok else 'FAIL'}")
    return ok, out


def _s_rounds(call, n: int) -> list:
    """Seconds of each of ``n`` calls, every card synchronized around each."""
    out = []
    for _ in range(n):
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        call()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        out.append(time.perf_counter() - t)
    return out


def drive_meshes_cards() -> tuple[bool, dict]:
    """The default mesh on every visible card (``device=None``: JAX's rule,
    as many rows as divide N) against a one-card mesh, s/round of each:
    ``bench.py``'s 64 MLP nodes (rounds eager; a fused span eager across
    cards, captured and replayed on one), the same with DP-SGD (clip 1.0,
    noise 1.1; eager on both), and ``main``'s LoRA federation at config
    5's width (4 nodes, one a row). The MLP's plain rounds bit-equal."""
    from p2pfl_tpu_torch.examples import bench_mnist
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops.tree import tree_map
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    cards = torch.cuda.device_count()
    if cards < 2:
        log("[meshes_cards] needs two cards")
        return False, {}
    _free_card()
    data = FederatedDataset.mnist(None, **bench_mnist.HARD_TASK)
    out: dict = {"cards": cards}
    feds = {}
    for name, mesh in (("default", None), ("one_card", federation_mesh(1, devices=["cuda:0"]))):
        for dp in ({}, dict(dp_clip=1.0, dp_noise=1.1)):
            fed = SpmdFederation.from_dataset(mlp(), data, n_nodes=bench_mnist.N_NODES, batch_size=bench_mnist.BATCH,
                                              vote=False, seed=3, keep_opt_state=True, mesh=mesh, **dp)
            fed.run_round()  # warm
            row = {"rows": int(fed.mesh.devices.size), "s_round": _s_rounds(fed.run_round, 3)}
            fed.run_fused(4)  # captured on one card
            row["s_round_fused_span"] = [t / 4 for t in _s_rounds(lambda f=fed: f.run_fused(4), 2)]
            row["span_captured"] = bool(fed._spans)
            out[f"mlp_{name}{'_dp' if dp else ''}"] = row
            if not dp:
                feds[name] = fed
    def host(tree):
        return tree_map(lambda x: x.cpu(), tree)

    bits = all(_tree_bits_equal(host(feds["default"].node_params(i)), host(feds["one_card"].node_params(i)))
               for i in (0, bench_mnist.N_NODES - 1))
    del feds
    _free_card()
    _, ldata, model = _main_model("auto")
    for name, mesh in (("default", None), ("one_card", federation_mesh(1, devices=["cuda:0"]))):
        fed = SpmdLoraFederation.from_dataset(model, ldata, n_nodes=MAIN["nodes"], batch_size=1, vote=False, seed=3,
                                              mesh=mesh)
        fed.run_round()  # warm
        out[f"lora_{name}"] = {"rows": int(fed.mesh.devices.size), "s_round": _s_rounds(fed.run_round, 2)}
        del fed
        _free_card()
    checks = {
        "the default mesh spans every card": out["mlp_default"]["rows"] == math.gcd(cards, bench_mnist.N_NODES),
        "DP-SGD runs on the default mesh": out["mlp_default_dp"]["rows"] == out["mlp_default"]["rows"],
        "MLP rounds and spans bit-equal to one card": bits,
    }
    out["checks"] = checks
    ok = all(checks.values())
    log(f"[meshes_cards] {json.dumps(out)} {'OK' if ok else 'FAIL'}")
    return ok, out


PHASES = ("kernels", "offs", "main", "node_lora", "ring", "parity", "exchange", "gossip", "sharded", "wire",
          "compress", "mnist", "cifar", "chunked", "nameplate", "config7", "moe", "async", "megafleet", "meshes")
#: phases that need more than one card: run only when named in --only
MULTI_CARD_PHASES = ("exchange_peer", "meshes_cards")
#: the runs to a target accuracy (minutes each) and the control of the
#: lossy codecs' spread limit: run only when named in --only
TARGET_PHASES = ("chunked_target", "nameplate_target", "compress_control", "moe_target", "round_flops", "trace_flash",
                 "trace_cifar", "gpipe_target")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="+", choices=PHASES + MULTI_CARD_PHASES + TARGET_PHASES,
                        default=list(PHASES))
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from p2pfl_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib = _kernels.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s")
    for line in build_report(lib.with_suffix(".log").read_text()):
        log(f"[build] {line}")

    ok = True
    timings: dict = {}
    offs_timings: dict = {}
    #: kernel → {path: its launches in that path's drive}, counts zeroed
    #: before each drive and read after it; the first path is the kernel's
    #: main path
    launches: dict = {}
    phase_s: dict = {}

    #: kernel → {path: {head width: launches}}
    by_width: dict = {}

    def count(path: str, counts: dict, names, widths: dict = None) -> None:
        """Record a drive's counts; ``widths`` gives them by head width
        (name → {width: n}), else the drive ran the width-64 models."""
        for name in names:
            if counts[name]:
                launches.setdefault(name, {})[path] = counts[name]
                if name.startswith("flash_"):
                    split = widths[name] if widths else {64: counts[name]}
                    by_width.setdefault(name, {})[path] = {d: n for d, n in split.items() if n}

    def timed(name, fn, *a):
        t = time.perf_counter()
        result = fn(*a)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return result

    if "kernels" in args.only:
        ok &= timed("kernels", check_kernels, timings)
    if "offs" in args.only:
        ok &= timed("offs", check_offs_kernels, offs_timings)
        ok &= timed("ring_timing", time_ring, offs_timings)
    if "main" in args.only:
        good, fused = timed("main_fused", drive_main_path, "auto")
        ok &= good
        count("main", fused["launches"], ("flash_fwd", "flash_bwd_dkvq"))
        good, split = timed("main_split", drive_main_path, "split")
        ok &= good
        count("main", split["launches"], ("flash_bwd_dq", "flash_bwd_dkv"))
    if "node_lora" in args.only:
        good, node_lora = timed("node_lora", drive_node_lora)
        ok &= good
        # kernels 1-4 on the gossip Node's path, each experiment apart
        for mode, run in node_lora["runs"].items():
            count(f"node_lora_{mode}", run["launches"], ("flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv"))
    if "ring" in args.only:
        good, fused = timed("ring_fused", drive_ring_path, "auto", 22)
        ok &= good
        count("ring", fused["launches"], ("flash_fwd_offs", "flash_bwd_dkvq_offs"))
        good, split = timed("ring_split", drive_ring_path, "split", 22)
        ok &= good
        count("ring", split["launches"], ("flash_bwd_dq_offs", "flash_bwd_dkv_offs"))
    if "parity" in args.only:
        good, _ = timed("parity_flash", round_parity)
        ok &= good
        good, _ = timed("parity_ring", round_parity, "ring_flash", 512, 4)
        ok &= good
    exchange_timings: dict = {}
    if "exchange" in args.only:
        ok &= timed("exchange", check_exchange, exchange_timings)
    if "gossip" in args.only:
        good, gossip = timed("gossip", drive_gossip)
        ok &= good
        count("gossip", {"ici_exchange": gossip["ici"]["launches_ici_exchange"]}, ("ici_exchange",))
    sharded: dict = {}
    if "sharded" in args.only:
        good, sharded = timed("sharded", drive_sharded)
        ok &= good
        # kernels 1-2 the timed rounds, 1, 3, 4 the split check at
        # model_parallel 4; kernel 9 the sharded Nodes' shard sends
        fed = sharded["federation"]
        count("sharded", fed["launches_fused"], ("flash_fwd", "flash_bwd_dkvq"))
        count("sharded_split", fed["launches_split"], ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        count("sharded_nodes", {"ici_exchange": sharded["nodes"]["launches_ici_exchange"]}, ("ici_exchange",))
    if "wire" in args.only:
        good, wire = timed("wire", drive_wire)
        ok &= good
        if "grpc_ici" in wire["runs"]:
            # kernel 9 also carries the gRPC fleet's weights on the ici plane
            count("wire_grpc_ici", {"ici_exchange": wire["runs"]["grpc_ici"]["launches_ici_exchange"]},
                  ("ici_exchange",))
    compress: dict = {}
    if "compress" in args.only:
        good, compress = timed("compress", drive_compress)
        ok &= good
        # kernel 9 carries the codec payloads on the ICI plane (MLP and
        # LoRA Nodes); kernels 1 and 2 run the LoRA Nodes' steps
        count("compress_ici", {"ici_exchange": compress["ici"]["launches_ici_exchange"]}, ("ici_exchange",))
        count("compress_lora", compress["lora"]["launches"], ("flash_fwd", "flash_bwd_dkvq", "ici_exchange"))
    if "mnist" in args.only:
        good, _ = timed("mnist", drive_mnist)
        ok &= good
    if "cifar" in args.only:
        good, _ = timed("cifar", drive_cifar)
        ok &= good
    if "chunked" in args.only:
        good, _ = timed("chunked", drive_chunked)
        ok &= good
    if "nameplate" in args.only:
        good, nameplate = timed("nameplate", drive_nameplate)
        ok &= good
        count("nameplate", nameplate["launches"], ("flash_fwd", "flash_bwd_dkvq"))
    if "config7" in args.only:
        good, c7 = timed("config7", drive_config7)
        ok &= good
        for path, counts in c7["launches"].items():
            count(path, counts, ("flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv"),
                  c7["launches_by_width"][path])
    if "moe" in args.only:
        good, _ = timed("moe", drive_moe)
        ok &= good
    if "async" in args.only:
        good, async_out = timed("async", drive_async)
        ok &= good
        # kernel 9 carries every async payload between the Nodes' slots
        for mode, row in async_out["threaded"].items():
            count(f"async_{mode}", {"ici_exchange": row["launches_ici_exchange"]}, ("ici_exchange",))
        for part in ("byzantine", "resume"):
            if part in async_out:
                count(f"async_{part}", {"ici_exchange": async_out[part]["launches_ici_exchange"]}, ("ici_exchange",))
    megafleet: dict = {}
    if "megafleet" in args.only:
        good, megafleet = timed("megafleet", drive_megafleet)
        ok &= good
        count("megafleet", {"fleet_chunk": megafleet["kernel_row"]["launches"]}, ("fleet_chunk",))
    if "meshes" in args.only:
        good, meshes = timed("meshes", drive_meshes)
        ok &= good
        # kernels 1-2 in the pipelined step at config 5 (b), 1, 3, 4 in the
        # LoRA round on the (4, 4) mesh with the base split (d)
        count("meshes_gpipe5", meshes["gpipe5"]["launches_pipe"], ("flash_fwd", "flash_bwd_dkvq"))
        count("meshes_lora_tp", meshes["lora_tp"]["split_base"]["launches"], ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    if "moe_target" in args.only:
        good, _ = timed("moe_target", drive_moe_target)
        ok &= good
    if "round_flops" in args.only:
        good, _ = timed("round_flops", drive_round_flops)
        ok &= good
    if "trace_flash" in args.only:
        good, _ = timed("trace_flash", drive_trace_flash)
        ok &= good
    if "trace_cifar" in args.only:
        good, _ = timed("trace_cifar", drive_trace_cifar)
        ok &= good
    if "gpipe_target" in args.only:
        good, _ = timed("gpipe_target", drive_gpipe_target)
        ok &= good
    if "chunked_target" in args.only:
        good, _ = timed("chunked_target", drive_chunked_target)
        ok &= good
    if "nameplate_target" in args.only:
        good, _ = timed("nameplate_target", drive_nameplate_target)
        ok &= good
    if "compress_control" in args.only:
        good, _ = timed("compress_control", drive_compress_control)
        ok &= good
    if "exchange_peer" in args.only:
        ok &= timed("exchange_peer", check_exchange_peer, {})
    if "meshes_cards" in args.only:
        good, _ = timed("meshes_cards", drive_meshes_cards)
        ok &= good
    log(f"[time] seconds per phase: {json.dumps(phase_s)}")
    log(f"[time] whole run {time.perf_counter() - t_run:.1f} s")

    # kernels 1-4 report the causal case, the offset kernels the diagonal
    # hop, kernel 9 the gossip path's tree (the MLP's six fp32 leaves)
    rows = {**timings.get("causal", {}), **offs_timings.get("diagonal", {})}
    if "mlp_fp32" in exchange_timings:
        rows["ici_exchange"] = dict(exchange_timings["mlp_fp32"])
        if compress.get("ici", {}).get("kernel9_codec_tree"):
            # the same kernel on the codec tree (int32 idx, int8 q, fp32
            # scales and the raw leaves of one update)
            rows["ici_exchange"]["codec_tree"] = compress["ici"]["kernel9_codec_tree"]
    if "ici_exchange" in rows and sharded:
        # the same kernel on a sharded node's slot blocks (config 5, 4 slots)
        rows["ici_exchange"]["sharded_tree"] = sharded["exchange"]["sharded_tree"]
    if megafleet:
        rows["fleet_chunk"] = {k: megafleet["kernel_row"][k] for k in (
            "max_abs_err", "ms", "ms_per", "ms_one_chunk_launch", "plain_ms", "bound_ms", "bound_by",
            "latency_bound_ms", "library_ms")}
    if rows:
        for d in WIDTH_SHAPES:
            for name, row in timings.get(f"D{d}", {}).items():
                rows.setdefault(name, {}).setdefault("widths", {})[str(d)] = row
        kernels = [
            {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
             "launches": next(iter(launches.get(name, {}).values()), 0),
             "launches_by_path": launches.get(name, {}),
             **({"launches_by_width": by_width[name]} if name in by_width else {}), **rows[name]}
            for name in REPLACES if name in rows
        ]
        print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any phase's failure must exit non-zero
        traceback.print_exc()
        sys.exit(1)
