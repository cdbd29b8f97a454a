"""The paper's technique on a language model, on the port
(``examples/population_lm.py``): PBT over a population of reduced-config
LMs, one vectorized update stream (one ``pop_adam`` launch a step for the
whole population on the card), with checkpointing.

The same ``repro_torch.pop`` machinery drives the RL setting and this
one: the script is nothing but a config for the train entry point, with
the JAX example's ``--resume none`` (``--resume auto`` continues the run
in ``--ckpt-dir``; a fresh temporary directory unless one is given).
``--log-dir DIR`` writes the run's telemetry as ``DIR/telemetry.jsonl``
(``tools/report.py``).

    python -m repro_torch.examples.population_lm [--ckpt-dir DIR] \\
        [--resume auto] [--log-dir DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.launch import train


def run(ckpt_dir, *, steps=60, device=DEFAULT_DEVICE, resume="none",
        log_dir=None):
    """The JAX example's run: qwen2-0.5b at ``.smoke()`` width, 4 members
    of 4 x 64 tokens, PBT every 20 steps. Returns the train CLI's
    report."""
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--population", "4",
            "--steps", str(steps), "--batch", "4", "--seq-len", "64",
            "--pbt-interval", "20", "--ckpt-dir", str(ckpt_dir),
            "--resume", resume, "--device", device]
    if log_dir is not None:
        argv += ["--log-dir", str(log_dir)]
    return train.main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for the checkpoints (default: a "
                    "temporary one)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--resume", default="none", choices=["auto", "none"],
                    help="auto: continue from the latest checkpoint in "
                    "--ckpt-dir")
    ap.add_argument("--log-dir", default=None,
                    help="also write DIR/telemetry.jsonl (tools/report.py)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kwargs = dict(steps=args.steps, device=args.device, resume=args.resume,
                  log_dir=args.log_dir)
    if args.ckpt_dir is not None:
        return run(args.ckpt_dir, **kwargs)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        return run(ckpt_dir, **kwargs)


if __name__ == "__main__":
    main()
