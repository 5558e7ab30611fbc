"""Command-line interface: ``python -m remap_tpu_torch.cli <frames-dir>``
(port of remap_tpu/cli.py).

Mirrors the reference binary's contract (main.cpp:246-266): a directory
of numerically named raw frame dumps in, ``out<i>.png`` world maps out,
with flags for the screen geometry, frame format, artifact constants,
device batch sizes and checkpoints that the reference hardcodes
(main.cpp:194-244).  The flags and exit codes are the JAX CLI's: 1 for
an unreadable or empty directory or an unknown palette, 2 when no action
window is found, else 0.  The build runs on the CUDA card; ``--cpu``
runs it on the CPU instead.  ``--distributed`` first joins a
``torch.distributed`` process group (``parallel.distributed``: NCCL, one
rank a GPU; gloo with ``--cpu``), and then every process runs the build
on its own device and writes the maps, as the JAX CLI's processes do
after ``jax.distributed.initialize``.
"""

from __future__ import annotations

import argparse
import os
import sys

from remap_tpu_torch.config import MatchConfig, PipelineConfig


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="remap-tpu-torch",
        description="Reconstruct a game world map from captured frames.",
    )
    p.add_argument("frames_dir", help="directory of frame files")
    p.add_argument("--format", choices=["raw", "png"], default="raw",
                   help="frame file format (raw = 1 byte/px palette codes)")
    p.add_argument("--width", type=int, default=388,
                   help="screen width (raw format; reference: 388)")
    p.add_argument("--height", type=int, default=312,
                   help="screen height (raw format; reference: 312)")
    p.add_argument("--out-prefix", default="out",
                   help="output PNG prefix (out -> out1.png, ...)")
    p.add_argument("--artifact-dev", type=float, default=2.0)
    p.add_argument("--artifact-size", type=int, default=15)
    p.add_argument("--matcher", choices=["grid_vote", "xcorr", "pyramid"],
                   default="grid_vote",
                   help="alignment family for collect AND splice "
                        "(grid_vote = reference parity)")
    p.add_argument("--weight-switch", type=int, default=10)
    p.add_argument("--region-votes", type=int, default=3)
    p.add_argument("--frame-batch", type=int, default=128)
    p.add_argument("--region-capacity", type=int, default=768)
    p.add_argument("--vote-radius", type=int, default=16,
                   help="vote histogram radius; 0 = exact full-range "
                        "counting (out-of-range votes auto-escalate)")
    p.add_argument("--splice-capacity", type=int, default=2048)
    p.add_argument("--frame-store", choices=["auto", "hbm", "host"],
                   default="auto",
                   help="frame-store device residency: hbm keeps the "
                        "packed frames and medians of collect on the card "
                        "for the later passes; host keeps them host-side "
                        "only; auto is hbm on CUDA")
    p.add_argument("--discovery", choices=["parity", "robust"],
                   default="parity",
                   help="window discovery: 'parity' replicates the "
                        "reference exactly (including its zero-output "
                        "regimes on top-HUD and glitchy-chrome captures); "
                        "'robust' picks the largest changed contour and "
                        "debounces transient glitches (PARITY.md)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="dump stage checkpoints for resume/debug")
    p.add_argument("--resume", action="store_true",
                   help="restart from the latest stage checkpoint under "
                        "--checkpoint-dir instead of recomputing it")
    p.add_argument("--palette", default="c64",
                   help="16-color palette: a preset (c64/zx/ega) or a "
                        "file of 16 RRGGBB hex lines (the reference "
                        "hardcodes c64, cpl.hpp:77-92); affects the "
                        "luminance-order tables and PNG input/output")
    p.add_argument("--perf", action="store_true",
                   help="print per-stage seconds and fps")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group before "
                        "any device use (NCCL, one rank a GPU; gloo with "
                        "--cpu); the parameters below default to "
                        "torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE "
                        "and RANK")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's address host:port (with --distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if not args.distributed:
        return _run(args)
    import torch.distributed as dist

    from remap_tpu_torch.parallel import distributed

    joined = not dist.is_initialized()
    try:
        distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id,
                               device="cpu" if args.cpu else None)
    except (ValueError, RuntimeError) as e:
        print(f"cannot join the process group: {e}", file=sys.stderr)
        return 1
    try:
        return _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def pipeline_config(args) -> PipelineConfig:
    """The pipeline's settings that the parsed arguments ``args`` ask
    for."""
    return PipelineConfig(
        screen_width=args.width,
        screen_height=args.height,
        matcher=args.matcher,
        match=MatchConfig(weight_switch=args.weight_switch,
                          region_votes=args.region_votes),
        artifact_filter_dev=args.artifact_dev,
        artifact_filter_size=args.artifact_size,
        frame_batch=args.frame_batch,
        region_capacity=args.region_capacity,
        vote_radius=args.vote_radius,
        splice_capacity=args.splice_capacity,
        discovery=args.discovery,
        frame_store=args.frame_store,
    )


def _run(args) -> int:
    if args.palette != "c64":
        from remap_tpu_torch.core import palette

        if args.palette in palette.PRESETS:
            palette.set_palette(args.palette)
        elif os.path.exists(args.palette):
            palette.set_palette(palette.load_palette_file(args.palette))
        else:
            print(f"unknown palette {args.palette!r}: not a preset "
                  f"({'/'.join(sorted(palette.PRESETS))}) and not a file",
                  file=sys.stderr)
            return 1

    from remap_tpu_torch.device import get_device
    from remap_tpu_torch.io import frames as frames_io
    from remap_tpu_torch.io import png as png_io
    from remap_tpu_torch.pipeline import builder

    try:
        device = get_device("cpu" if args.cpu else None)
        if args.distributed:
            from remap_tpu_torch.parallel.distributed import local_device

            device = local_device()
    except RuntimeError as e:
        print(f"{e} (--cpu runs on the CPU)", file=sys.stderr)
        return 1

    cfg = pipeline_config(args)

    try:
        if args.format == "raw":
            feed = frames_io.RawDirectoryFeed(args.frames_dir, args.width,
                                              args.height)
        else:
            feed = frames_io.PngDirectoryFeed(args.frames_dir)
    except (FileNotFoundError, NotADirectoryError) as e:
        print(f"cannot read frames: {e}", file=sys.stderr)
        return 1
    if len(feed) == 0:
        print(f"no frames in {args.frames_dir}", file=sys.stderr)
        return 1

    callbacks = builder.PerfCallbacks() if args.perf else None
    # the feed itself (restartable and iterable): the builder then takes
    # its with_crop / read_packed_batch path instead of a generator's
    result = builder.build(
        lambda: feed, cfg, callbacks=callbacks,
        device=device,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume)
    if result.window is None and not (
            args.resume and args.checkpoint_dir and result.maps):
        print("no action window found", file=sys.stderr)
        return 2

    for i, image in enumerate(result.maps, start=1):
        path = f"{args.out_prefix}{i}.png"
        png_io.write_map(path, image)
        print(f"wrote {path} ({image.shape[1]}x{image.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
