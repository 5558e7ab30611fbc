"""The control: the reference with its uint16 vote counters narrowed to
uint8 (the step a later change would take to halve the vote bytes), in
the program's place, must come out not correct."""

from port_bench import harness, traffic
from port_bench.reference import stream as ref_stream
from port_bench.tests import small


def test_map_control_fails(tmp_path):
    # a small world, so every canvas pixel takes hundreds of votes
    _, _, config, workload = small.cell("c64_map_clean", frames=400,
                                        margin=24)
    sound, control = harness.control_checks(config, workload, 9, 0.0,
                                            "cpu", str(tmp_path))
    assert not any(sound.values()), sound
    # one number failing is enough: here the canvases' votes
    assert control["splice_bins_wrong"] > 0


def test_stream_control_fails():
    bench, entry, config, workload = small.cell("nes_stream_ingest")
    s = traffic.make(config, workload["traffic"], 3)
    p = config["pipeline"]
    want = ref_stream.stream(s.path, 4096, p["frame_batch"],
                             config["atlas_pad"], p["screen_width"],
                             p["screen_height"])
    full = ref_stream.atlas(s.frames, want, "cpu", bits=16)
    narrow = ref_stream.atlas(s.frames, want, "cpu", bits=8)
    assert int((full != narrow).sum()) > 0
    assert int(full.max()) > 255
