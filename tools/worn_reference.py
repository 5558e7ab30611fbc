#!/usr/bin/env python3
"""The JAX package's world-map agreement on chip_smoke.py's worn
platformer session, on the CPU: the reference figure behind
chip_smoke.WORN_AGREEMENT.

    python3 tools/worn_reference.py

Makes the session with the JAX package's own ``utils.gameplay`` and
``utils.wear`` (chip_smoke.worn_session's seeds and sizes), writes it as
numbered raw dumps, builds it as ``python -m remap_tpu.cli <dir> --cpu``
does at its default flags (``RawDirectoryFeed`` into ``builder.build``),
and prints the world map's interior agreement with the session's world
as chip_smoke.world_agreement judges it (aligned by frame record 0), as
one JSON line.  Takes minutes on a CPU.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from remap_tpu.cli import make_parser  # noqa: E402
from remap_tpu.config import MatchConfig, PipelineConfig  # noqa: E402
from remap_tpu.io import frames as frames_io  # noqa: E402
from remap_tpu.pipeline import builder, clean  # noqa: E402
from remap_tpu.utils import gameplay, wear  # noqa: E402


def cli_config(args) -> PipelineConfig:
    """The configuration remap_tpu.cli.main builds from its flags."""
    return PipelineConfig(
        screen_width=args.width, screen_height=args.height,
        matcher=args.matcher,
        match=MatchConfig(weight_switch=args.weight_switch,
                          region_votes=args.region_votes),
        artifact_filter_dev=args.artifact_dev,
        artifact_filter_size=args.artifact_size,
        frame_batch=args.frame_batch, region_capacity=args.region_capacity,
        vote_radius=args.vote_radius, splice_capacity=args.splice_capacity,
        discovery=args.discovery, frame_store=args.frame_store)


def main() -> int:
    session = chip_smoke.worn_session(gameplay, wear)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_raw(f"{tmp}/worn", session.frames)
        args = make_parser().parse_args([f"{tmp}/worn"])
        feed = frames_io.RawDirectoryFeed(args.frames_dir, args.width,
                                          args.height)
        t0 = time.perf_counter()
        res = builder.build(lambda: feed, cli_config(args))
        seconds = time.perf_counter() - t0
    agree, compared = chip_smoke.world_agreement(
        res, session.world, chip_smoke.session_origins(session),
        res.window.crop, margins=clean.margins_of_fragment)
    print(json.dumps({
        "frames": len(session.frames), "maps": [list(m.shape)
                                                for m in res.maps],
        "agree": agree, "compared": compared, "share": agree / compared,
        "build_s": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
