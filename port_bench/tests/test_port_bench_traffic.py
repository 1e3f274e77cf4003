"""The length generator: the same sizes for every seed, in a seeded order, in bounds."""

import pytest

from port_bench import harness
from port_bench.traffic import lengths

H = harness.config("hifigan_v1")
MIXES = ["ljspeech_closed_b1", "ljspeech_buckets_b16", "ljspeech_live16"]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_are_the_same_set_for_every_seed_and_in_bounds(name):
    mix = harness.mix(name)
    utt, rnd = mix["utterances"], mix.get("round_frames", 1)
    frames = lengths.frames(H, utt, rnd)
    assert frames == lengths.frames(H, utt, rnd) and frames == sorted(frames)
    lo = utt["min_s"] * H["sampling_rate"] / H["hop_size"]
    hi = utt["max_s"] * H["sampling_rate"] / H["hop_size"] + rnd
    assert all(lo <= f <= hi and f % rnd == 0 for f in frames)
    assert len(frames) == utt["count"]
    mean_s = sum(lengths.durations(utt)) / utt["count"]
    assert abs(mean_s - utt["mean_s"]) < 0.15


def test_order_is_deterministic_by_seed():
    a, b = lengths.order(256, 2 ** 31 + 11, "requests"), lengths.order(256, 2 ** 31 + 11, "requests")
    c = lengths.order(256, 2 ** 31 + 12, "requests")
    assert a == b and a != c and sorted(c) == list(range(256))


def test_serving_lengths_cover_26_shapes_from_96_to_896_frames():
    frames = lengths.frames(H, harness.mix("ljspeech_closed_b1")["utterances"], 32)
    assert min(frames) == 96 and max(frames) == 896 and len(set(frames)) == 26


def test_buckets_hold_one_length_each_and_every_utterance():
    frames = lengths.frames(H, harness.mix("ljspeech_buckets_b16")["utterances"], 64)
    batches = lengths.buckets(frames, 16)
    assert all(len(idx) == 16 and {frames[i] for i in idx} == {f} for f, idx in batches)
    assert {i for _, idx in batches for i in idx} == set(range(len(frames)))


def test_stream_groups_span_the_lengths():
    n, s = 256, 16
    groups = lengths.groups(n, s)
    assert sorted(i for g in groups for i in g) == list(range(n))
    assert all(len(g) == s and g[-1] >= n - n // s for g in groups)
