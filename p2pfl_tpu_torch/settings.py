"""Runtime knobs of the port (counterpart of ``p2pfl_tpu/settings.py``).

Only the knobs the ported slices read, with the JAX package's names and
defaults. Mutate the class attributes to change them, as there.
"""

from __future__ import annotations


class Settings:
    # --- general ---
    LOG_LEVEL: str = "INFO"
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
    # the byte codec of the in-memory transport is not ported (ROADMAP
    # A3/A4): True raises at Node.start
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
    # secure aggregation is a gossip-plane protocol; the SPMD federation
    # refuses it (one program is one trust domain) and the Node's secagg
    # verbs are not ported (True raises at Node.start)
    SECURE_AGGREGATION: bool = False
    # aggregation accumulates in this dtype
    AGG_DTYPE: str = "float32"
    # models compute in this dtype (parameters and logits stay float32);
    # ``models/vision.py::MLP`` reads it when built
    COMPUTE_DTYPE: str = "bfloat16"
    # SCAFFOLD's new control variate from the epoch's fp32 gradient mean
    # (exact under plain SGD, keeps no round-start params); False takes
    # option II's (x - y_i)/(K·lr) from the round-start anchor
    SCAFFOLD_FUSED_CI: bool = True

    # --- monitoring (management/telemetry.py) ---
    TELEMETRY_ENABLED: bool = True
    TELEMETRY_RING_SPANS: int = 4096
    TELEMETRY_BEAT_SPANS: bool = False

    # --- mesh ---
    # ``nodes`` indexes federated nodes (mesh slots); ``data`` is
    # intra-node batch parallelism and ``model`` intra-node parallelism
    # (the sequence shards of ring attention)
    MESH_NODES_AXIS: str = "nodes"
    MESH_MODEL_AXIS: str = "model"
    MESH_DATA_AXIS: str = "data"

    # --- weights planes ---
    # wire compression of model payloads: only "none" is ported (the
    # int8/topk8 codecs are ROADMAP A5); with the ICI plane on, anything
    # else raises at Node.start
    WIRE_COMPRESSION: str = "none"
    # "bytes": model payloads ride the transport (the in-memory transport
    # hands the sender's tensors over by reference); "ici": between nodes
    # registered on the shard plane they move slot to slot through
    # parallel/ici_plane.py (kernel 9 on the card), the control plane
    # staying on the transport (communication/ici.py)
    WEIGHTS_PLANE: str = "bytes"


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
    Settings.WEIGHTS_PLANE = "bytes"
    Settings.SCAFFOLD_FUSED_CI = True
    Settings.TRAIN_SET_SIZE = 4
    Settings.VOTE_TIMEOUT = 10.0
    Settings.AGGREGATION_TIMEOUT = 10.0
    Settings.WAIT_HEARTBEATS_CONVERGENCE = 0.4
    Settings.LOG_LEVEL = "DEBUG"
