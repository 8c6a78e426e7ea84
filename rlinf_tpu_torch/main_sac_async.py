"""Async SAC entry point of the port: a squashed-Gaussian SAC policy on a
built-in env through the asynchronous actor-learner.

The port's ``examples/embodiment/train_sac_async.py``: the rollout thread
fills a replay buffer while the learner takes SAC steps
(``AsyncEmbodiedRunner``), then a deterministic eval on 64 envs of seed
123. The settings are the example's; the run is on the card unless
``device="cpu"`` (``--device cpu``) is given.

Usage:
  python -m rlinf_tpu_torch.main_sac_async --device cpu --env bandit --num-envs 32 \\
      --steps 50 --log-dir /tmp/sac_async
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence


def main(device="cuda", env: str = "point_reach", num_envs: int = 64, steps: int = 2000,
         log_dir: Optional[str] = "logs/sac_async", runner_cfg=None, sac=None,
         policy_kw=None) -> Dict:
    """Train ``steps`` learner steps on ``num_envs`` envs of ``env``, then
    evaluate. ``runner_cfg`` (an ``AsyncRunnerConfig``), ``sac`` (a
    ``SACConfig``) and ``policy_kw`` replace the example's defaults.
    Returns {"metrics": the last step's, "eval", "runner"}."""
    import dataclasses

    from rlinf_tpu_torch.envs import get_env_cls
    from rlinf_tpu_torch.models.embodiment.sac_policy import MLPSACPolicy
    from rlinf_tpu_torch.runners.async_embodied_runner import (
        AsyncEmbodiedRunner,
        AsyncRunnerConfig,
    )
    from rlinf_tpu_torch.training.sac_learner import SACConfig

    Env = get_env_cls(env)
    train_env = Env(num_envs=num_envs, seed=0)
    cfg = dataclasses.replace(runner_cfg or AsyncRunnerConfig(), total_train_steps=steps,
                              log_dir=log_dir)
    runner = AsyncEmbodiedRunner(
        cfg, envs=[train_env],
        policy=MLPSACPolicy(obs_dim=train_env.obs_spec["states"][0],
                            action_dim=train_env.action_dim, **(policy_kw or {})),
        sac=sac or SACConfig(), device=device,
    )
    metrics = runner.run()
    evaluation = runner.evaluate(Env(num_envs=64, seed=123))
    runner.logger.close()
    return {"metrics": metrics, "eval": evaluation, "runner": runner}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Async SAC on a built-in env, on the port")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda, or cpu)")
    parser.add_argument("--env", default="point_reach")
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--log-dir", default="logs/sac_async")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    print(main(_args.device, _args.env, _args.num_envs, _args.steps, _args.log_dir)["eval"])
