"""Embodied PPO entry point of the port: a Gaussian MLP policy on the
built-in PointReach env.

The port's ``examples/embodiment/train_ppo_point_reach.py``: vectorized
envs split into pipelined stages, a Gaussian MLP policy, GAE and PPO
epochs over minibatches (``EmbodiedRunner``), with a deterministic eval
every 25 steps on 64 envs of seed 999. The settings are the example's; the
run is on the card unless ``device="cpu"`` (``--device cpu``) is given.

Usage:
  python -m rlinf_tpu_torch.main_embodied_ppo --device cpu --num-envs 64 --steps 2 \\
      --log-dir /tmp/ppo_point_reach
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence


def main(device="cuda", num_envs: int = 256, stages: int = 2, steps: int = 200,
         log_dir: Optional[str] = "logs/ppo_point_reach") -> Dict:
    """Train for ``steps`` runner steps on ``num_envs`` envs split into
    ``stages`` stages. Returns {"history": the step metrics, "runner"}."""
    from rlinf_tpu_torch.envs import get_env_cls
    from rlinf_tpu_torch.models.embodiment import MLPGaussianPolicy
    from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig
    from rlinf_tpu_torch.training.train_state import OptimizerConfig

    Env = get_env_cls("point_reach")
    per_stage = num_envs // stages
    runner = EmbodiedRunner(
        EmbodiedRunnerConfig(
            num_chunk_steps=32, num_epochs=2, num_mini_batches=4,
            gamma=0.9, gae_lambda=0.95, max_steps=steps,
            eval_interval=25, log_dir=log_dir,
        ),
        envs=[Env(num_envs=per_stage, seed=s) for s in range(stages)],
        policy=MLPGaussianPolicy(obs_dim=4, action_dim=2, init_logstd=-0.5),
        optimizer=OptimizerConfig(lr=3e-3, clip_grad=1.0),
        eval_envs=[Env(num_envs=64, seed=999)],
        device=device,
    )
    history = runner.run()
    runner.logger.close()
    return {"history": history, "runner": runner}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Embodied PPO on PointReach, on the port")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda, or cpu)")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--stages", type=int, default=2)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--log-dir", default="logs/ppo_point_reach")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    main(_args.device, _args.num_envs, _args.stages, _args.steps, _args.log_dir)
