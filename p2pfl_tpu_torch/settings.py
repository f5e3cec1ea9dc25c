"""Runtime knobs of the port (counterpart of ``p2pfl_tpu/settings.py``).

Only the knobs the ported slice reads, with the JAX package's names and
defaults. Mutate the class attributes to change them, as there.
"""

from __future__ import annotations


class Settings:
    # --- learning round ---
    # size of the elected train set (reference vote_train_set_stage)
    TRAIN_SET_SIZE: int = 4
    # the reference elects once, in round 0; True re-elects every round
    VOTE_EVERY_ROUND: bool = False
    # secure aggregation is a gossip-plane protocol; the SPMD federation
    # refuses it (one program is one trust domain)
    SECURE_AGGREGATION: bool = False
