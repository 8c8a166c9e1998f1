"""Command-line entry point.

``python -m nbodyax.cli [--config nbodyConfig.txt] [--set key=value ...]``

The reference hardcodes its config filename and has no argv handling (the
parsing code is commented out, /root/reference/src/nbody.cu:381-383); we default
to the same ``nbodyConfig.txt`` and add overrides on top. Echoes settings the
way the reference does (nbody.cu:376-378) and prints the same final
``Time taken:`` line (nbody.cu:548).
"""

from __future__ import annotations

import argparse
import os
import sys

from nbodyax.config import SimConfig, apply_overrides, parse_config_file
from nbodyax.driver import run_simulation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nbodyax",
        description="n-body simulation with collisions")
    ap.add_argument("--config", default="nbodyConfig.txt",
                    help="config file (reference nbodyConfig.txt format)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (repeatable)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override totalIterations")
    ap.add_argument("--no-images", action="store_true",
                    help="skip frame rendering")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace into DIR")
    ap.add_argument("--debug-nans", action="store_true",
                    help="enable jax_debug_nans (fail fast on NaN/Inf; the "
                         "framework's analog of the reference's debug asserts, "
                         "nbody.cu:234-236)")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume from checkpoint file (or 'auto' for latest "
                         "in checkpointPath)")
    args = ap.parse_args(argv)

    from nbodyax.cache import enable_compile_cache
    enable_compile_cache()
    if args.debug_nans:
        import jax
        jax.config.update("jax_debug_nans", True)

    if os.path.exists(args.config):
        if not args.quiet:
            print("Running simulation with the following settings:")
        cfg = parse_config_file(args.config, verbose=not args.quiet)
        if not args.quiet:
            print("=====================")
    else:
        if args.config != "nbodyConfig.txt":
            print(f"Error opening config file! ({args.config})", file=sys.stderr)
            return 1
        # the reference hard-errors here (nbodyConfig.h:26-28); we fall back
        # to built-in defaults but say so, so a typo'd cwd is visible before
        # a multi-minute default run starts
        print("No nbodyConfig.txt found; running the built-in default scene "
              "(pass --config or cd to the config's directory)",
              file=sys.stderr)
        cfg = SimConfig()
    cfg = apply_overrides(cfg, args.set)
    if args.steps is not None:
        cfg.total_iterations = args.steps
    if args.no_images:
        cfg.save_images = False
    if args.resume:
        if args.resume == "auto":
            from nbodyax.io.checkpoint import latest_checkpoint
            ck = latest_checkpoint(cfg.checkpoint_path)
            if ck is None:
                print(f"No checkpoint found in {cfg.checkpoint_path}",
                      file=sys.stderr)
                return 1
            cfg.resume_from = ck
        else:
            cfg.resume_from = args.resume

    run_simulation(cfg, quiet=args.quiet, profile_dir=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
