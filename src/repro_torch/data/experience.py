"""The experience contract (``repro.data.experience``), replay half: the
replay item of an env. The rollout engine inserts it into the
population's FIFO ring (``repro_torch.data.replay_buffer``); the
trajectory kind (PPO's rollouts and GAE) comes with the PPO slice."""
from __future__ import annotations

import torch


def transition_spec(spec) -> dict:
    """One replay item for an env spec: name -> (shape, dtype)."""
    f32 = torch.float32
    action = (((), torch.int32) if spec.discrete
              else ((spec.act_dim,), f32))
    return {"obs": ((spec.obs_dim,), f32),
            "action": action,
            "reward": ((), f32),
            "next_obs": ((spec.obs_dim,), f32),
            "done": ((), f32)}
