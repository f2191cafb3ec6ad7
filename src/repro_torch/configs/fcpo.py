"""FCPO hyperparameters — paper Table II, plus the action-space definition.

The port's own copy of ``repro.configs.fcpo.FCPOConfig``: same fields, same
defaults (the port imports nothing of the JAX package).

| param                         | paper | here |
|-------------------------------|-------|------|
| n_s   steps/episode           | 10    | 10   |
| LR    iAgent learning rate    | 1e-3  | 1e-3 |
| θ, ς, φ reward weights (Eq.1) | 1.1, 10, 2 | same |
| γ, λ  discount / GAE (Eq.2)   | 0.1   | same |
| ω     loss penalty (Eq.3)     | 0.2   | same |
| ε     policy clip (Eq.4)      | 0.9   | same |
| α, β  diversity weights (Eq.6)| 0.5   | same |

Action space (§II-B): RES — input-resolution bucket / frame-packing factor;
BS — inference batch size; MT — pre/post-processing concurrency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class FCPOConfig:
    # --- iAgent network (Fig. 4) ---
    state_dim: int = 8
    hidden_dim: int = 64
    feat_dim: int = 48
    n_res: int = 4            # resolution buckets: x1, x0.75, x0.5, x0.25
    n_bs: int = 7             # batch sizes: 1,2,4,8,16,32,64
    n_mt: int = 4             # threads: 1..4

    # --- RL (Table II) ---
    n_steps: int = 10         # steps per episode
    lr: float = 1e-3
    theta: float = 1.1        # ϑ reward throughput weight
    sigma: float = 10.0       # ς reward latency weight
    phi: float = 2.0          # φ reward oversize weight
    gamma: float = 0.1        # discount
    lam: float = 0.1          # GAE lambda
    omega: float = 0.2        # loss penalty weight (Eq. 3)
    eps_clip: float = 0.9     # ε in Eq. 4
    alpha: float = 0.5        # diversity: Mahalanobis weight (Eq. 6)
    beta: float = 0.5         # diversity: KL weight (Eq. 6)

    # --- CRL overhead minimization (§IV-C) ---
    buffer_size: int = 64     # small fixed-size experience buffer
    loss_gate: float = 0.05   # skip backprop when |loss| below this
    policy_mode: str = "fcpo"  # "fcpo" = Eq.4 literal; "ppo" = standard clip
    single_head: bool = False  # ablation (Fig. 12): one joint action head
    hidden_scale: int = 1      # BCEdge-style bulky agent multiplier

    # --- FL (§IV-D) ---
    fl_every: int = 2         # aggregate every 2nd episode (Fig. 14 setup)
    finetune_steps: int = 2   # action-head fine-tune steps after aggregation
    clients_per_round: float = 0.5   # fraction selected by Eq. 7 utility
    hierarchical_period: int = 4     # cross-pod exchange every N cluster rounds

    # --- action values ---
    res_scales: Tuple[float, ...] = (1.0, 0.75, 0.5, 0.25)
    bs_values: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    mt_values: Tuple[int, ...] = (1, 2, 3, 4)

    # --- environment ---
    slo_s: float = 0.25       # 250 ms end-to-end SLO


DEFAULT = FCPOConfig()
