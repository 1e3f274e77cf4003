"""The port's multilabel data engine (no pandas) against the JAX engine, on
the CPU, on the synthetic corpus of ``tests/test_data_engine.py``: the
corpus table (rows, column order and types), a CSV source with a
numeric-looking column enriched by a join and a retype, the label option
and weight tables (key order included), items and batches bit for bit for
one seed with augmentation on and off, per-host striding, the golden-ratio
subsample, the quarantine of a corrupt row and the label-cache warm. Each
side gets a cache directory of its own, so no side reads the other's
pickles."""

import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

from hifigan_tpu.data import complex_parser as jparser
from hifigan_tpu_torch.data import complex_parser as tparser
from tests.test_data_engine import AUG_CONFIG, SR, corpus, make_dataset  # noqa: F401


def port_dataset(corpus, **over):  # noqa: F811
    from hifigan_tpu_torch.data.multilabel import MultilabelWaveDataset

    kwargs = dict(data_dir=corpus["data"], aug_dir=corpus["aug"], cache_dir=corpus["cache"],
                  name="train", source="train", segment_length=2400, sampling_rate=SR,
                  embedding_size=240, augmentation_config=AUG_CONFIG, num_workers=1)
    kwargs.update(over)
    return MultilabelWaveDataset(**kwargs)


def pair(corpus, tmp, **over):  # noqa: F811
    """(JAX dataset, port dataset) of the same arguments, separate caches."""
    return (make_dataset(corpus, cache_dir=str(tmp / "jax_cache"), **over),
            port_dataset(corpus, cache_dir=str(tmp / "port_cache"), **over))


def assert_table_matches(frame, table):
    assert table.names == list(frame.columns)
    assert len(table) == len(frame)
    for name in frame.columns:
        kind = frame[name].dtype.kind
        assert table[name].dtype.kind == (kind if kind in "ifb" else "O"), name
        want = frame[name].tolist()
        got = table[name].tolist()
        assert [type(v) for v in got] == [type(v) for v in want], name
        assert got == want, name
    for i in range(len(frame)):  # a row's values as ``iloc[i][name]`` gives them
        want = frame.iloc[i]
        got = table.row(i)
        assert list(got) == list(want.index)
        assert all(type(got[k]) is type(want[k]) and got[k] == want[k] for k in got), i


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def assert_items_equal(a, b):
    wav_a, path_a, frames_a, utt_a = a
    wav_b, path_b, frames_b, utt_b = b
    assert wav_a.dtype == wav_b.dtype == np.float32
    np.testing.assert_array_equal(wav_a, wav_b)
    assert path_a == path_b
    assert_trees_equal(frames_a, frames_b)
    assert_trees_equal(utt_a, utt_b)


@pytest.fixture(scope="module")
def datasets(corpus, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("engine")
    return {"aug": pair(corpus, tmp / "aug", deterministic=True),
            "plain": pair(corpus, tmp / "plain", augmentation_config=None, deterministic=True)}


def test_corpus_table_matches_jax(datasets):
    jds, tds = datasets["plain"]
    assert_table_matches(jds.index.table, tds.index.table)
    assert Path(tds.index.cache_root / "corpus_table.pickle").exists()
    assert not Path(tds.index.cache_root / "corpus_index.pickle").exists()


def test_csv_join_retype_rename_and_size_match_jax(tmp_path):
    """A CSV source whose ``id`` and ``score`` columns look numeric, glob
    rows joined to it, a retype of ``id`` to str and ``age`` to float, a
    rename and a row cap: the same table as pandas builds."""
    data = tmp_path / "data"
    (data / "wavs").mkdir(parents=True)
    for name in ("s1_a", "s2_b", "s1_c", "s3_d", "s9_e"):
        (data / "wavs" / f"{name}.wav").write_bytes(b"")
    (data / "speakers.csv").write_text(
        "# speaker table\n"
        "id, sex , age,score,known\n"
        "1, m, 30, 0.5,True\n"
        "2, f, 41, 1,False\n"
        "3, f, 25, 2.25,true\n"
        "1, m, 31, 7,TRUE\n")
    config = [
        {"group-name": "speakers",
         "sources": [{"type": "csv", "path": "speakers.csv", "delimiter": ",", "skiprows": 1}]},
        {"group-name": "wavs",
         "sources": [{"type": "glob", "glob": "wavs/*.wav", "label": "path"},
                     {"type": "glob", "glob": "wavs/s1_*.wav", "label": "path", "size": 1}],
         "group-labels": {"mic-brand": "blueyeti", "take": 2},
         "enrichments": [
             {"type": "regex", "patterns": {"path": r"s(?P<spk>\d)_(?P<utt>\w)\.wav$"}},
             {"type": "retype", "mapping": {"spk": "int"}},
             {"type": "join", "other-group-name": "speakers", "base-label": "spk",
              "other-label": "id"},
             {"type": "files", "labels": {"wav": "wavs/s{spk}_{utt}.wav"}},
             {"type": "retype", "mapping": {"id": "str", "age": "float", "take": "str"}},
             {"type": "rename", "mapping": {"sex": "gender"}},
         ]},
    ]
    want = jparser.parse_complex_data(data, data, config, "wavs")
    got = tparser.parse_complex_data(data, data, config, "wavs")
    assert len(want) > 4  # speaker 1 appears twice in the CSV
    assert_table_matches(want, got)
    speakers = jparser.parse_complex_data(data, data, config[:1], "speakers")
    assert {k: v.kind for k, v in speakers.dtypes.items()}["score"] == "f"
    assert_table_matches(speakers, tparser.parse_complex_data(data, data, config[:1], "speakers"))
    select = dict(config[1], enrichments=config[1]["enrichments"] + [
        {"type": "select", "labels": ["wav", "gender", "age"]}])
    assert_table_matches(jparser.parse_complex_data(data, data, [config[0], select], "wavs"),
                         tparser.parse_complex_data(data, data, [config[0], select], "wavs"))


def test_value_counts_breaks_ties_as_pandas():
    import pandas as pd

    values = ["spk2", "spk1", "spk3", "spk1", "spk2", "spk4"]
    table = tparser.Table({"speaker": values})
    assert table.value_counts("speaker") == list(pd.Series(values).value_counts().items())


@pytest.mark.parametrize("kind", ["aug", "plain"])
def test_label_tables_match_jax(datasets, kind):
    jds, tds = datasets[kind]
    for name in ("label_options_groups", "label_weights_groups", "label_options",
                 "label_weights", "label_options_weights"):
        assert_trees_equal(getattr(jds, name), getattr(tds, name))
    for group, labels in jds.label_options_groups.items():
        assert list(tds.label_options_groups[group]) == list(labels)
        for label, options in labels.items():
            assert list(tds.label_options_groups[group][label]) == list(options)


@pytest.mark.parametrize("kind", ["aug", "plain"])
def test_items_match_jax_bit_for_bit(datasets, kind):
    jds, tds = datasets[kind]
    assert len(jds) == len(tds) == 4
    for i in range(len(jds)):
        assert_items_equal(jds[i], tds[i])


def test_batches_with_per_host_striding_match_jax(datasets):
    jds, tds = datasets["aug"]
    for host in range(2):
        kw = dict(seed=3, drop_last=False, process_index=host, process_count=2)
        got = list(tds.batches(1, **kw))
        want = list(jds.batches(1, **kw))
        assert len(got) == len(want) == 2
        for b_want, b_got in zip(want, got):
            assert b_got["paths"] == b_want["paths"]
            np.testing.assert_array_equal(b_got["audio"], b_want["audio"])
            assert_trees_equal(b_want["time_labels"], b_got["time_labels"])
            for ua, ub in zip(b_want["grouped_labels"], b_got["grouped_labels"]):
                assert_trees_equal(ua, ub)


def test_golden_ratio_subsample_matches_jax(corpus, tmp_path):  # noqa: F811
    jds, tds = pair(corpus, tmp_path, size=2, deterministic=True, augmentation_config=None)
    assert len(tds) == 2
    assert [tds._scan_row(i) for i in range(2)] == [jds._scan_row(i) for i in range(2)] != [0, 1]
    for i in range(2):
        assert_items_equal(jds[i], tds[i])


def test_quarantine_matches_jax(corpus, tmp_path):  # noqa: F811
    """A corpus with one TextGrid that has no word tier: both engines
    quarantine the same row and drop it. Both leave ``quarantine.pickle``
    as the empty list the index writes when it starts (the JAX engine's
    ``create_pickle_cache`` does not overwrite it), so a later start scans
    the row again."""
    root = tmp_path / "corpus"
    shutil.copytree(Path(corpus["data"]).parent, root,
                    ignore=shutil.ignore_patterns("cache", "*_cache"))
    broken = sorted((root / "data").glob("**/tg/*.TextGrid"))[1]
    broken.write_text(broken.read_text().replace('name = "words"', 'name = "other"'))
    copy = {"data": str(root / "data"), "aug": str(root / "aug"), "cache": str(root / "cache")}
    jds, tds = pair(copy, tmp_path, augmentation_config=None, deterministic=True)
    assert len(jds) == len(tds) == 3
    assert_table_matches(jds.index.table, tds.index.table)
    read = [pickle.loads(Path(ds.index.quarantine_path).read_bytes()) for ds in (jds, tds)]
    assert read[0] == read[1] == []
    for i in range(3):
        assert_items_equal(jds[i], tds[i])


def test_warm_label_caches_writes_the_jax_pickles(corpus, tmp_path):  # noqa: F811
    from hifigan_tpu.cli.warm_cache import warm_label_caches as jwarm
    from hifigan_tpu_torch.cli.warm_cache import warm_label_caches

    jds, tds = pair(corpus, tmp_path, disable_wavs=True, augmentation_config=None)
    jwarm(jds, workers=1)
    warm_label_caches(tds, workers=2)
    for i in range(len(tds)):
        want = pickle.loads((jds._frame_label_dir / f"{i}.pickle").read_bytes())
        got = pickle.loads((tds._frame_label_dir / f"{i}.pickle").read_bytes())
        assert_trees_equal(want, got)


def test_label_stats_cache_is_shared_with_jax_layout(datasets):
    jds, tds = datasets["plain"]
    read = [pickle.loads((ds.index.cache_root / "label_stats.pickle").read_bytes())
            for ds in (jds, tds)]
    assert_trees_equal(*read)


def test_worker_pool_spawns_once_cuda_is_initialised(monkeypatch):
    """The label scan's and the warm's pool forks only before CUDA is
    initialised in the process; after, it starts its workers with spawn."""
    import multiprocessing

    import torch

    from hifigan_tpu_torch.data import multilabel

    made = []
    real = multiprocessing.get_context
    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda method=None: made.append(method) or real(method))
    for initialised in (False, True):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda v=initialised: v)
        with multilabel.worker_pool(1) as pool:
            assert pool.map(abs, [-1, -2]) == [1, 2]
    assert made == [None, "spawn"]
