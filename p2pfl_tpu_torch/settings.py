"""Runtime knobs of the port (counterpart of ``p2pfl_tpu/settings.py``).

Only the knobs the ported slices read, with the JAX package's names and
defaults. Mutate the class attributes to change them, as there.

``COMPUTE_DTYPE="float32"`` means IEEE fp32 on the card as on the CPU:
importing :mod:`p2pfl_tpu_torch` turns TF32 off in cuBLAS's matmuls and
cuDNN's convolutions, once, and no knob turns it back on (PyTorch's default
would run an fp32 convolution in TF32, 10 mantissa bits). A caller who
wants TF32 sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` after the import.
"""

from __future__ import annotations

from typing import Optional


class Settings:
    # --- general ---
    # seconds; the gRPC transport's per-call deadline
    GRPC_TIMEOUT: float = 10.0
    LOG_LEVEL: str = "INFO"
    # directory of ``logger.enable_file_logging``'s rotating file
    LOG_DIR: str = "logs"
    EXCLUDE_BEAT_LOGS: bool = True

    # --- heartbeat (membership / failure detection) ---
    HEARTBEAT_PERIOD: float = 2.0
    HEARTBEAT_TIMEOUT: float = 5.0

    # --- gossip (message plane) ---
    GOSSIP_PERIOD: float = 0.1
    TTL: int = 10
    GOSSIP_MESSAGES_PER_PERIOD: int = 100
    AMOUNT_LAST_MESSAGES_SAVED: int = 100

    # --- gossip (model plane) ---
    GOSSIP_MODELS_PERIOD: float = 1.0
    GOSSIP_MODELS_PER_ROUND: int = 2
    GOSSIP_EXIT_ON_X_EQUAL_ROUNDS: int = 10
    # worker threads per gossiper for dispatching sends (1 = inline and
    # strictly sequential) and the per-send wall-clock budget
    GOSSIP_SEND_WORKERS: int = 4
    GOSSIP_SEND_TIMEOUT: float = 5.0
    # the in-memory transport round-trips weights through the byte codec
    # (encode on send, decode against the receiving learner) instead of
    # handing the sender's tensors over by reference
    MEMORY_WIRE_CODEC: bool = False

    # --- control-plane reliability (communication/reliability.py) ---
    MESSAGE_RETRY_MAX: int = 4
    MESSAGE_RETRY_BASE: float = 0.25
    MESSAGE_RETRY_CAP: float = 2.0
    BREAKER_THRESHOLD: int = 3
    BREAKER_SUSPECT_TIMEOUT: float = 4.0
    # mid-round train-set repair: an evicted member shrinks the round's
    # coverage target instead of stalling it until AGGREGATION_TIMEOUT
    TRAIN_SET_REPAIR: bool = True
    # an init_model that beat start_learning is kept this long
    EARLY_INIT_TTL: float = 15.0

    # --- learning round ---
    # size of the elected train set (reference vote_train_set_stage)
    TRAIN_SET_SIZE: int = 4
    VOTE_TIMEOUT: float = 60.0
    AGGREGATION_TIMEOUT: float = 300.0
    WAIT_HEARTBEATS_CONVERGENCE: float = 1.0
    # the reference elects once, in round 0; True re-elects every round
    VOTE_EVERY_ROUND: bool = False
    # secure aggregation (learning/secagg.py): train-set nodes agree a DH
    # seed per peer at experiment start and mask their contribution so the
    # masks cancel in the FedAvg sum. A gossip-plane protocol: the SPMD
    # federations refuse it (one program is one trust domain). FedAvg
    # only, and it needs WIRE_COMPRESSION="none"
    SECURE_AGGREGATION: bool = False
    # per-pair Gaussian mask scale: pair (i, j) is masked at
    # STD·sqrt(w_j/w_i) on node i (sample counts ride the DH keys)
    SECAGG_MASK_STD: float = 100.0
    # seconds a train-set node waits for peers' seed disclosures after an
    # aggregation timeout with dropouts, before the round becomes a no-op
    SECAGG_RECOVERY_TIMEOUT: float = 30.0
    # Bonawitz double masking: every contribution also carries a per-round
    # self mask whose seed is t-of-n Shamir-shared with the train set
    SECAGG_DOUBLE_MASK: bool = True
    # aggregation accumulates in this dtype
    AGG_DTYPE: str = "float32"
    # models compute in this dtype (parameters and logits stay float32);
    # ``models/vision.py::MLP`` reads it when built
    COMPUTE_DTYPE: str = "bfloat16"
    # SCAFFOLD's new control variate from the epoch's fp32 gradient mean
    # (exact under plain SGD, keeps no round-start params); False takes
    # option II's (x - y_i)/(K·lr) from the round-start anchor
    SCAFFOLD_FUSED_CI: bool = True
    # sequence length at and above which attn="auto" picks the flash
    # kernels over dense attention on a CUDA device (anywhere else "auto"
    # stays dense: the plain versions are a correctness path). JAX's is
    # 1024, its TPU crossover; on an H100 config 7's flash train step beat
    # dense's from T 512, the shortest length measured, in most runs
    # (host-bound steps; PERF.md; `python3 chip_smoke.py --only config7`
    # measures it)
    FLASH_MIN_SEQ_LEN: int = 512
    # the gossip Node's round compute (eval of the incoming model, every
    # local epoch, the node's own weighted partial-aggregation fold) as
    # one call (parallel/spmd.py::fused_node_round, driven by
    # TorchLearner.fused_round; on a card one replayed CUDA graph a node).
    # False keeps the staged evaluate() + fit() path, the parity baseline;
    # learners that cannot fuse (DummyLearner, LoRALearner, DP-SGD) take
    # it either way
    ROUND_FUSED: bool = True
    # retention of learning/checkpoint.py's save_state: keep the newest N
    # step directories; 0 = unbounded
    CHECKPOINT_KEEP_N: int = 0

    # --- federation round hot path (parallel/chunked.py) ---
    # how many chunks ahead ChunkedFederation stages its inputs (the
    # round's shuffle indices, and x/y chunks when the data is not
    # resident) while earlier chunks compute; 1 = stage each chunk just
    # before it runs (the serial order), 2 = double buffering
    CHUNK_STAGING_DEPTH: int = 2
    # fold each chunk's weighted contribution into preallocated fp32
    # accumulators as part of the chunk's work; False adds whole trees
    # after every chunk (the serial reference path the parity test uses)
    CHUNK_FUSED_REDUCE: bool = True
    # the fused accumulators are updated in place (``add_``); False adds
    # out of place into fresh tensors each chunk (the copy-safe path)
    CHUNK_DONATE_BUFFERS: bool = True

    # --- monitoring (management/telemetry.py) ---
    TELEMETRY_ENABLED: bool = True
    TELEMETRY_RING_SPANS: int = 4096
    TELEMETRY_BEAT_SPANS: bool = False
    # wrap each dispatch span's body in torch.profiler.record_function
    # ("p2pfl:<site>"), so a profiler trace holds the host dispatch ranges
    # beside the device kernels. None = on where the work runs on a CUDA
    # device (read through telemetry_annotations())
    TELEMETRY_ANNOTATIONS: Optional[bool] = None
    # seconds between NodeMonitor samples (management/node_monitor.py)
    RESOURCE_MONITOR_PERIOD: float = 1.0
    # stall watchdog (management/watchdog.py): when > 0, a daemon thread
    # dumps every thread's stack if a learning node makes no stage
    # transition for this many seconds. Detection only; 0 disables
    STALL_WATCHDOG_S: float = 0.0

    # --- mesh ---
    # ``nodes`` indexes federated nodes (mesh slots); ``data`` is
    # intra-node batch parallelism and ``model`` intra-node parallelism
    # (the sequence shards of ring attention)
    MESH_NODES_AXIS: str = "nodes"
    MESH_MODEL_AXIS: str = "model"
    MESH_DATA_AXIS: str = "data"
    # ``clients`` is the megafleet engine's 1-D mesh axis: the simulated
    # edge population's parameter rows are sharded over it while the small
    # admission and window state stays replicated
    # (parallel/fleet_mesh.py, ops/fleet_kernels.py ShardedFleet)
    MESH_CLIENTS_AXIS: str = "clients"

    # --- wire (learning/weights.py, communication/grpc_transport.py) ---
    # outgoing gRPC frame format: "envelope" (JSON-header frames) or
    # "protobuf" (the reference's node.proto schema, proto_wire.py);
    # receivers sniff every frame, so mixed fleets interoperate
    WIRE_FORMAT: str = "envelope"
    # wire compression of model payloads (learning/weights.py): "none";
    # "int8", symmetric per-tensor quantization (4x smaller payloads); or
    # "topk8", the top-k int8 deltas against the round-start global model
    # with error feedback (0.25 bytes a parameter at the default fraction)
    WIRE_COMPRESSION: str = "none"
    # fraction of delta coordinates topk8 keeps a tensor
    TOPK_FRACTION: float = 0.05
    # topk8's error feedback: dropped coordinates accumulate locally and
    # re-enter the next round's delta
    TOPK_ERROR_FEEDBACK: bool = True
    # the int8/topk8 encode as torch ops where the params live
    # (ops/compression.py; the residual stays there between rounds), and
    # the tk8 decode as a scatter onto the anchor where it lives. None
    # picks by the params' device: the device producer for CUDA tensors,
    # the host (numpy) producer on the CPU; True/False force it. Read the
    # resolved value through wire_compression_device()
    WIRE_COMPRESSION_DEVICE: Optional[bool] = None
    # streaming byte plane: a payload estimated at or above
    # WIRE_STREAM_THRESHOLD MB ships as P2TC chunk frames of about
    # WIRE_CHUNK_MB over send_weights_stream (the memory transport's byte
    # path through a queue of WIRE_STREAM_WINDOW frames); False neither
    # sends nor accepts streams (peers fall back to unary, counted)
    WIRE_STREAM_ENABLED: bool = True
    WIRE_STREAM_THRESHOLD: float = 8.0
    WIRE_CHUNK_MB: float = 2.0
    WIRE_STREAM_WINDOW: int = 4
    # gRPC max send/receive message size (MB) of every channel and server,
    # and the server's handler threads
    GRPC_MAX_MESSAGE_MB: int = 512
    GRPC_SERVER_WORKERS: int = 4

    # --- weights planes ---
    # "bytes": model payloads ride the transport (the in-memory transport
    # hands the sender's tensors over by reference); "ici": between nodes
    # registered on the shard plane they move slot to slot through
    # parallel/ici_plane.py (kernel 9 on the card), the control plane
    # staying on the transport (communication/ici.py)
    WEIGHTS_PLANE: str = "bytes"

    # --- async bounded-staleness federation (federation/) ---
    # the control plane of the learning thread: "sync" is the round FSM
    # (stages/learning_stages.py), "async" the FedBuff buffered plane
    # (federation/workflow.py: contributions merge as they arrive, weighted
    # by staleness, no round barrier). Any other value raises at Node.start
    FEDERATION_MODE: str = "sync"
    # buffer size K: an aggregator merges once K contributions are buffered
    # (clamped to the tier's live fan-in)
    FEDBUFF_K: int = 4
    # staleness exponent α of w(τ) = 1/(1+τ)^α, τ in global versions
    FEDBUFF_ALPHA: float = 0.5
    # server mixing rate η: global ← (1-η)·global + η·buffer mean
    FEDBUFF_SERVER_LR: float = 1.0
    # bounded staleness: a contribution older than this many versions is
    # dropped (async_stale_drop), never merged
    ASYNC_MAX_STALENESS: int = 16
    # HierFAVG clusters (federation/topology.py): members chunked into edge
    # clusters of this size, each with a regional aggregator; 0 = flat
    HIER_CLUSTER_SIZE: int = 0
    # how long a node serves after its own budget, waiting for the others'
    # async_done (an eviction releases it too)
    ASYNC_DRAIN_TIMEOUT: float = 30.0
    # how long a joiner waits for its bootstrap pull's global
    ASYNC_JOIN_TIMEOUT: float = 15.0
    # the crash-resurrection journal (federation/durability.py): a snapshot
    # every N own updates (and one at drain), the newest N kept, and a
    # resumed node's sequence counters restarted this far past the journal
    JOURNAL_EVERY_N_UPDATES: int = 1
    JOURNAL_KEEP_N: int = 3
    JOURNAL_SEQ_MARGIN: int = 16
    # --- megafleet (federation/megafleet.py, ops/fleet_kernels.py) ---
    # defaults of MegaFleet's fleet knobs, read once at construction. Pace
    # steering: each client's schedule is offset by a seeded uniform draw in
    # [0, PACE_WINDOW) virtual seconds (0 disables)
    MEGAFLEET_PACE_WINDOW: float = 0.0
    # selection: each (client, update) slot runs with this probability
    MEGAFLEET_SELECT_FRAC: float = 1.0
    # per-tier rate limits: virtual seconds between accepted offers at a
    # regional / the global window (0 disables)
    MEGAFLEET_REGIONAL_RATE_S: float = 0.0
    MEGAFLEET_GLOBAL_RATE_S: float = 0.0
    # events per chunk step of the chunked engine (1 = the per-event
    # reference engine; 0 = measure the candidates once on the device and
    # replay the winner from the fleet-tune cache, ops/fleet_autotune.py)
    MEGAFLEET_CHUNK: int = 256
    # shards of the sharded megafleet engine (ops/fleet_kernels.py
    # ShardedFleet): the per-client parameter rows are split over
    # MESH_CLIENTS_AXIS (CPU slots of a CPU fleet, the first visible cards
    # of a card fleet) while admission stays replicated, so verdicts are
    # bit-identical to the one-slot chunked engine. 0/1 = one slot
    MEGAFLEET_SHARDS: int = 0
    # per-shard segment head-room of the sharded chunk layout: each shard
    # owns ceil(SLACK * chunk / shards) lanes of a chunk, so a mildly
    # imbalanced chunk (one shard's clients over-represented) still packs
    # without closing the chunk early. Raising it trades per-shard work
    # (chunk/shards * SLACK trained lanes a shard) for fewer short chunks;
    # 2.0 keeps the aligned layout on every schedule the simulator makes
    MEGAFLEET_SHARD_SLACK: float = 2.0
    # path of the fleet-tune cache (chunk winners by device kind); empty =
    # ~/.cache/p2pfl_tpu_torch/fleet_tune.json
    FLEET_TUNE_CACHE: str = ""
    # --- Byzantine robustness (federation/defense.py, ops/aggregation.py) ---
    # the async buffer's fold: "fedavg" (staleness-weighted mean),
    # "trimmed-mean" / "median" (per-coordinate rank rules, weight-free) or
    # "krum-screen" (Krum drops BYZ_F outliers, the weighted mean folds the
    # rest)
    ASYNC_ROBUST_AGG: str = "fedavg"
    # coordinates trimmed from each side by "trimmed-mean" (clamped)
    ASYNC_TRIM: int = 1
    # assumed Byzantine contributions f of "krum-screen" (clamped)
    BYZ_F: int = 1
    # the admission screen at both aggregator seams (the sync add_model and
    # the async offer): a norm gate and a cosine gate against the current
    # global; rejections feed a per-origin suspicion EWMA that quarantines
    # through the eviction path past BYZ_SUSPICION_THRESHOLD
    BYZ_SCREEN: bool = False
    BYZ_NORM_GATE: float = 4.0
    BYZ_COS_GATE: float = 0.5
    BYZ_SUSPICION_BETA: float = 0.5
    BYZ_SUSPICION_THRESHOLD: float = 0.7


#: the control planes a Node runs (``Settings.FEDERATION_MODE``)
FEDERATION_MODES = ("sync", "async")


def wire_compression_device(device=None) -> bool:
    """Resolve ``Settings.WIRE_COMPRESSION_DEVICE``: an explicit True or
    False stands; None picks the device producer for tensors on a CUDA
    ``device`` and the host producer elsewhere (the JAX package's rule by
    backend, with the params' device type in the backend's place). Both
    producers emit frames of one layout, so the choice never changes
    what a receiver decodes."""
    explicit = Settings.WIRE_COMPRESSION_DEVICE
    if explicit is not None:
        return bool(explicit)
    return device is not None and getattr(device, "type", str(device).split(":")[0]) == "cuda"


def telemetry_annotations(device=None) -> bool:
    """Resolve ``Settings.TELEMETRY_ANNOTATIONS`` for work on ``device``:
    an explicit True or False stands; None is on for a CUDA device and off
    for the CPU or no device, where no device timeline exists to line the
    ranges up with."""
    explicit = Settings.TELEMETRY_ANNOTATIONS
    if explicit is not None:
        return bool(explicit)
    return device is not None and getattr(device, "type", str(device).split(":")[0]) == "cuda"


def set_low_latency_settings() -> None:
    """The low-latency profile for reliable local networks (the JAX
    package's): every verb, stall and timeout exit and the vote stay; only
    the clocks shrink, so rounds are not quantised to whole seconds of
    model-gossip ticks and heartbeats. Fan-out and capacity knobs are
    untouched."""
    Settings.GRPC_TIMEOUT = 2.0
    Settings.HEARTBEAT_PERIOD = 0.3
    Settings.HEARTBEAT_TIMEOUT = 1.5
    Settings.GOSSIP_PERIOD = 0.02
    Settings.GOSSIP_MODELS_PERIOD = 0.05
    Settings.VOTE_TIMEOUT = 15.0
    Settings.AGGREGATION_TIMEOUT = 60.0
    Settings.SECAGG_RECOVERY_TIMEOUT = 10.0
    Settings.WAIT_HEARTBEATS_CONVERGENCE = 0.4
    Settings.MESSAGE_RETRY_BASE = 0.1
    Settings.MESSAGE_RETRY_CAP = 0.8
    Settings.BREAKER_SUSPECT_TIMEOUT = 0.8


def set_test_settings() -> None:
    """Shrink every timeout for fast tests (the JAX package's preset)."""
    Settings.HEARTBEAT_PERIOD = 0.3
    Settings.HEARTBEAT_TIMEOUT = 1.5
    Settings.GOSSIP_PERIOD = 0.05
    Settings.TTL = 10
    Settings.GOSSIP_MESSAGES_PER_PERIOD = 100
    Settings.AMOUNT_LAST_MESSAGES_SAVED = 100
    Settings.GOSSIP_MODELS_PERIOD = 0.1
    Settings.GOSSIP_MODELS_PER_ROUND = 4
    Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 4
    Settings.GOSSIP_SEND_WORKERS = 4
    Settings.GOSSIP_SEND_TIMEOUT = 2.0
    Settings.MEMORY_WIRE_CODEC = False
    Settings.GRPC_TIMEOUT = 0.5
    Settings.WIRE_FORMAT = "envelope"
    # streaming on but the threshold far above any test model: streams
    # engage only where a test lowers the threshold
    Settings.WIRE_STREAM_ENABLED = True
    Settings.WIRE_STREAM_THRESHOLD = 8.0
    Settings.WIRE_CHUNK_MB = 2.0
    Settings.WIRE_STREAM_WINDOW = 4
    Settings.GRPC_MAX_MESSAGE_MB = 512
    Settings.GRPC_SERVER_WORKERS = 4
    Settings.MESSAGE_RETRY_MAX = 4
    Settings.MESSAGE_RETRY_BASE = 0.05
    Settings.MESSAGE_RETRY_CAP = 0.4
    Settings.BREAKER_THRESHOLD = 3
    Settings.BREAKER_SUSPECT_TIMEOUT = 0.6
    Settings.TRAIN_SET_REPAIR = True
    Settings.EARLY_INIT_TTL = 15.0
    Settings.TELEMETRY_ENABLED = True
    Settings.TELEMETRY_RING_SPANS = 4096
    Settings.TELEMETRY_BEAT_SPANS = False
    Settings.WIRE_COMPRESSION = "none"
    # explicit, as in the JAX package's preset: tests drive the device
    # producer's code on whatever device they run on
    Settings.WIRE_COMPRESSION_DEVICE = True
    Settings.WEIGHTS_PLANE = "bytes"
    Settings.SCAFFOLD_FUSED_CI = True
    Settings.ROUND_FUSED = True
    Settings.CHECKPOINT_KEEP_N = 0
    Settings.CHUNK_STAGING_DEPTH = 2
    Settings.CHUNK_FUSED_REDUCE = True
    Settings.CHUNK_DONATE_BUFFERS = True
    Settings.TRAIN_SET_SIZE = 4
    Settings.VOTE_TIMEOUT = 10.0
    Settings.AGGREGATION_TIMEOUT = 10.0
    Settings.SECAGG_RECOVERY_TIMEOUT = 6.0
    Settings.WAIT_HEARTBEATS_CONVERGENCE = 0.4
    Settings.LOG_LEVEL = "DEBUG"
    Settings.FEDERATION_MODE = "sync"
    Settings.ASYNC_ROBUST_AGG = "fedavg"
    Settings.ASYNC_TRIM = 1
    Settings.BYZ_F = 1
    Settings.BYZ_SCREEN = False
    Settings.BYZ_NORM_GATE = 4.0
    Settings.BYZ_COS_GATE = 0.5
    Settings.BYZ_SUSPICION_BETA = 0.5
    Settings.BYZ_SUSPICION_THRESHOLD = 0.7
    Settings.FEDBUFF_K = 4
    Settings.FEDBUFF_ALPHA = 0.5
    Settings.FEDBUFF_SERVER_LR = 1.0
    Settings.ASYNC_MAX_STALENESS = 16
    Settings.HIER_CLUSTER_SIZE = 0
    Settings.ASYNC_DRAIN_TIMEOUT = 15.0
    Settings.ASYNC_JOIN_TIMEOUT = 5.0
    Settings.JOURNAL_EVERY_N_UPDATES = 1
    Settings.JOURNAL_KEEP_N = 3
    Settings.JOURNAL_SEQ_MARGIN = 16
    Settings.MEGAFLEET_PACE_WINDOW = 0.0
    Settings.MEGAFLEET_SELECT_FRAC = 1.0
    Settings.MEGAFLEET_REGIONAL_RATE_S = 0.0
    Settings.MEGAFLEET_GLOBAL_RATE_S = 0.0
    # a small odd chunk: every parity test crosses chunk boundaries
    Settings.MEGAFLEET_CHUNK = 48
    Settings.MEGAFLEET_SHARDS = 0
    Settings.MEGAFLEET_SHARD_SLACK = 2.0
    Settings.MESH_CLIENTS_AXIS = "clients"
    Settings.FLEET_TUNE_CACHE = ""
