"""Multi-label waveform data engine (host side of the distillation trainer;
port of ``hifigan_tpu/data/multilabel.py`` without pandas).

Capability parity with reference
``speech_distillation/multilabel_wave_dataset.py`` (items carry a waveform,
its source path, per-frame label-id tensors on the embedding grid, and the
per-utterance label values), re-designed for this framework:

- A :class:`CorpusIndex` owns corpus assembly (declarative data configs via
  ``complex_parser``), the pickle-cached index table, the corrupt-row
  quarantine, and label statistics. The dataset itself only crops, augments
  and batches.
- Frame labels are plain numpy string arrays rasterised from TextGrid
  intervals with slice assignment. The corpus table is
  ``complex_parser.Table`` (the JAX engine's pandas frame, same rows and
  column types); the trainer consumes stacked numpy host batches.
- Everything heavy is cached: the corpus table (``corpus_table.pickle``: a
  name of its own, because the JAX engine's ``corpus_index.pickle`` holds a
  pandas frame, which only pandas can unpickle),
  label statistics (``label_stats.pickle``), per-item frame labels
  (``frame_labels/<i>.pickle``), and the quarantine list
  (``quarantine.pickle``) — warm them ahead of training with
  ``cli/warm_cache.py``. The other caches hold plain Python and numpy
  values and are the JAX engine's files.
- The label scan and the cache warm fan out over a ``multiprocessing``
  pool, started with ``spawn`` once CUDA is initialised in the process
  (a fork of a process holding a CUDA context is unsafe).

Behavioral contract mirrored from the reference (same math, own shape):
taxonomy (content = speaker/sex/phones/sad; style = mic-brand + the seven
augmentation labels, ref :33-40), speech-activity tiers derived from word
alignments (ref :313-325), presence/absence label ratios (ref :172-219),
golden-ratio deterministic subsampling (ref :257), embedding-grid-aligned
random crops (ref :432-476), probability-tree augmentation (ref :478-517),
and the zero-waveform ``disable_wavs`` mode for label-only training.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

import numpy as np
import torch

from hifigan_tpu_torch.audio.io import load_wav
from hifigan_tpu_torch.data.augmentation import (
    CodecAugmentor,
    HighpassAugmentor,
    HilbertAugmentor,
    LowpassAugmentor,
    NoiseAugmentor,
    ReverbAugmentor,
    RirAugmentor,
)
from hifigan_tpu_torch.data.complex_parser import (
    Table,
    concat_rows,
    get_path_by_glob,
    parse_complex_data,
)
from hifigan_tpu_torch.data.textgrid import parse_textgrid
from hifigan_tpu_torch.utils.caching import create_pickle_cache, do_with_pickle_cache

# golden ratio: deterministic low-discrepancy subsampling stride
_GOLDEN = (1 + math.sqrt(5)) / 2

# ---------------------------------------------------------------------------
# label taxonomy
# ---------------------------------------------------------------------------

# labels read straight off the corpus table (one value per utterance)
UTTERANCE_LABELS = ("speaker", "sex", "mic-brand")
# labels carried as per-frame tensors on the embedding grid
FRAME_LABELS = ("phones", "sex", "speaker", "sad")
# utterance labels that are gated by speech activity (silence -> 'silence')
ACTIVITY_GATED = ("sex", "speaker")

TAXONOMY = {
    "content": ("speaker", "sex", "phones", "sad"),
    "style": ("mic-brand",),
}
AUGMENTATION_TAXONOMY = {
    "content": (),
    "style": ("noise", "rir", "lowpass", "highpass", "reverb", "codec", "hilbert"),
}


def _none_first(ratios: dict, none_default: float) -> dict:
    """Order a {option: ratio} dict with 'none' pinned to slot 0 and the
    rest by descending ratio — option order IS the class-id assignment."""
    ratios = dict(ratios)
    ratios.setdefault("none", none_default)
    rest = sorted((k for k in ratios if k != "none"), key=lambda k: -ratios[k])
    return {k: ratios[k] for k in ("none", *rest)}


def worker_pool(workers: int):
    """A ``multiprocessing`` pool of ``workers``; under ``spawn`` once this
    process holds a CUDA context."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn" if torch.cuda.is_initialized() else None)
    return ctx.Pool(workers)


# ---------------------------------------------------------------------------
# corpus index
# ---------------------------------------------------------------------------


class CorpusIndex:
    """Corpus table + label statistics for one source split.

    The table is a ``complex_parser.Table`` with one row per utterance (columns at
    least: wav glob, textgrid glob, and the utterance labels), assembled
    from every ``**/data_configs/<source>/*.json`` declarative config under
    ``data_dir`` and pickle-cached. Rows whose alignments fail to parse are
    quarantined (``quarantine.pickle``) and dropped on the next start."""

    def __init__(self, data_dir: str, cache_dir: str, source: str):
        self.data_dir = data_dir
        self.source = source
        self.cache_root = Path(cache_dir) / source
        (self.cache_root / "frame_labels").mkdir(parents=True, exist_ok=True)

        quarantined = do_with_pickle_cache(lambda: [], str(self.quarantine_path))
        self.table = do_with_pickle_cache(
            self._assemble_table, str(self.cache_root / "corpus_table.pickle")
        )
        self.drop_rows(quarantined)

    # -- assembly ------------------------------------------------------

    @property
    def quarantine_path(self) -> Path:
        return self.cache_root / "quarantine.pickle"

    def _assemble_table(self) -> Table:
        frames = []
        root = Path(self.data_dir)
        pattern = f"**/data_configs/{self.source}/*.json"
        for corpus_dir in sorted(root.glob("*/")):
            for spec_path in sorted(corpus_dir.glob(pattern)):
                try:
                    spec = json.loads(spec_path.read_text())
                    print(f"corpus [{spec['name']}]: scanning...")
                    frames.append(
                        parse_complex_data(corpus_dir, root, spec["config"], spec["result"])
                    )
                    print(f"corpus [{spec['name']}]: {len(frames[-1])} rows")
                except Exception as err:  # noqa: BLE001 — skip broken specs
                    print(f"corpus spec {spec_path} skipped: {err}")
        if not frames:
            return None
        return concat_rows(frames)

    def drop_rows(self, row_ids) -> None:
        if len(row_ids):
            self.table = self.table.drop(row_ids)

    def __len__(self) -> int:
        return len(self.table)

    # -- per-row raw accessors ------------------------------------------

    def utterance_labels(self, row: int) -> dict:
        values = self.table.row(row)
        return {name: values[name] for name in UTTERANCE_LABELS}

    def interval_tiers(self, row: int) -> dict[str, dict[str, np.ndarray]]:
        """TextGrid tiers for a row, extended with the derived tiers:
        'sad' (speech-activity from the word tier) and activity-gated
        copies of the utterance labels (ref :313-325)."""
        tiers = parse_textgrid(self.data_dir, self.table["textgrid"][row])
        words = tiers["words"]
        activity = dict(words, text=np.where(words["text"] == "", "silence", "speech"))
        tiers["sad"] = activity
        utt = self.utterance_labels(row)
        for name in ACTIVITY_GATED:
            tiers[name] = dict(activity, text=np.where(activity["text"] == "silence",
                                                       "silence", utt[name]))
        return {name: tiers[name] for name in FRAME_LABELS if name in tiers}

    # -- label statistics -------------------------------------------------

    def label_ratios(self, scan_rows, workers: int | None = None) -> dict:
        """{label: {'true': {option: ratio}, 'false': {...}}} with 'none'
        first — cached as label_stats.pickle. ``scan_rows`` maps a scan
        position to a table row (the golden-ratio subsample when a size cap
        is active)."""
        return do_with_pickle_cache(
            lambda: self._scan_label_ratios(scan_rows, workers),
            str(self.cache_root / "label_stats.pickle"),
        )

    def _scan_label_ratios(self, scan_rows, workers: int | None) -> dict:
        import multiprocessing

        indices = list(scan_rows)
        workers = workers or min(16, multiprocessing.cpu_count())
        if workers > 1:
            with worker_pool(workers) as pool:
                scans = pool.map(self._try_tier_durations, indices)
        else:
            scans = [self._try_tier_durations(i) for i in indices]

        # quarantine rows whose alignments failed; survivors drive the stats
        bad = [row for row, d in zip(indices, scans) if d is None]
        good = [d for d in scans if d is not None]
        create_pickle_cache(lambda: bad, str(self.quarantine_path))
        self.drop_rows(bad)
        if not good:
            raise RuntimeError(
                f"corpus [{self.source}]: label scan left no usable rows"
            )

        stats: dict = {}
        # utterance labels: plain class frequencies over the table
        n_rows = len(self.table)
        for name in UTTERANCE_LABELS:
            counts = self.table.value_counts(name)
            stats[name] = {
                "true": {k: v / n_rows for k, v in counts},
                "false": {k: (n_rows - v) / n_rows for k, v in counts},
            }
        # frame labels: presence/absence rates over scanned items — an
        # option is 'present' in an item when it covers any time at all,
        # 'absent-somewhere' when it does not cover the item entirely
        n_items = len(good)
        for name in FRAME_LABELS:
            present: dict = {}
            not_everywhere: dict = {}
            for durations in good:
                total = sum(durations[name].values())
                for option, covered in durations[name].items():
                    present[option] = present.get(option, 0) + (covered > 0)
                    not_everywhere.setdefault(option, 0)
            for option in not_everywhere:
                full_cover = sum(
                    1
                    for durations in good
                    if durations[name].get(option, 0.0)
                    >= sum(durations[name].values())
                )
                not_everywhere[option] = n_items - full_cover
            stats[name] = {
                "true": {k: v / n_items for k, v in present.items()},
                "false": {k: v / n_items for k, v in not_everywhere.items()},
            }
        return {
            name: {
                "true": _none_first(value["true"], none_default=0.0),
                "false": _none_first(value["false"], none_default=1.0),
            }
            for name, value in stats.items()
        }

    def _try_tier_durations(self, row: int):
        """Per-option covered duration for every frame-label tier of one
        row, or None when the row's alignments are corrupt."""
        try:
            durations = {}
            for name, tier in self.interval_tiers(row).items():
                spans = tier["end"] - tier["start"]
                per_option: dict = {}
                for option, span in zip(tier["text"], spans):
                    per_option[option] = per_option.get(option, 0.0) + float(span)
                durations[name] = per_option
            return durations
        except Exception as err:  # noqa: BLE001 — quarantine, don't crash
            print(f"corpus [{self.source}] row {row} quarantined: {err}")
            return None


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


class MultilabelWaveDataset:
    """Items: ``(wav, wav_path, frame_labels, utterance_labels)`` where
    ``frame_labels`` is ``{group: {label: (T_emb,) int64}}`` on the
    embedding grid and ``utterance_labels`` is ``{group: {label: value}}``.
    """

    def __init__(self, data_dir, aug_dir, cache_dir, name, source, segment_length,
                 sampling_rate, embedding_size, augmentation_config=None,
                 disable_wavs=False, split=True, size=None, fine_tuning=False,
                 deterministic=False, num_workers: int | None = None):
        self.data_dir = data_dir
        self.aug_dir = aug_dir
        self.name = name
        self.segment_length = segment_length
        self.embedding_size = embedding_size
        self.sampling_rate = sampling_rate
        self.split = split
        self.fine_tuning = fine_tuning
        self.deterministic = deterministic
        self.disable_wavs = disable_wavs
        self.should_augment = augmentation_config is not None

        print(f"dataset [{name}]: building index")
        self.index = CorpusIndex(data_dir, cache_dir, source)
        self.size = len(self.index) if size is None else size
        self._frame_label_dir = self.index.cache_root / "frame_labels"

        stats = self.index.label_ratios(
            (self._scan_row(i) for i in range(len(self))), workers=num_workers
        )
        if self.should_augment:
            self.aug_options = augmentation_config["options"]
            self.aug_probs = augmentation_config["probs"]
            stats = {**stats, **self._augmentation_ratios()}
        self._publish_label_tables(stats)

        if self.should_augment:
            self.augmentors = {
                "noise": NoiseAugmentor(aug_dir, self.label_options).augment,
                "rir": RirAugmentor(aug_dir).augment,
                "reverb": ReverbAugmentor(sampling_rate).augment,
                "lowpass": LowpassAugmentor(sampling_rate).augment,
                "highpass": HighpassAugmentor(sampling_rate).augment,
                "codec": CodecAugmentor(sampling_rate).augment,
                "hilbert": HilbertAugmentor(sampling_rate).augment,
            }
        print(f"dataset [{name}]: ready ({len(self)} items)")

    # -- label tables -------------------------------------------------

    def _augmentation_ratios(self) -> dict:
        """Priors for the augmentation labels straight from the probability
        tree: P(option) = P(augment) * P(this augmentor) * 1/|options|,
        'disabled' takes the rest, 'none' never occurs (ref :86-99)."""
        ratios = {}
        p_any = self.aug_probs["prob"]
        for aug, options in self.aug_options.items():
            p_sub = self.aug_probs["sub_probs"][aug]["prob"]
            p_each = p_any * p_sub / len(options)
            true = {
                "none": 0.0,
                "disabled": 1.0 - p_any * p_sub,
                **{option: p_each for option in options},
            }
            ratios[aug] = {
                "true": true,
                "false": {k: 1.0 - v for k, v in true.items()},
            }
        return ratios

    def _publish_label_tables(self, stats: dict) -> None:
        """Materialise the grouped option/weight views consumed by the
        model builders and callbacks."""
        grouped_names = {
            group: (*TAXONOMY[group], *AUGMENTATION_TAXONOMY[group])
            for group in TAXONOMY
        }
        self.label_options_weights = stats
        self.label_options_weights_groups = {
            group: {name: stats[name] for name in names if name in stats}
            for group, names in grouped_names.items()
        }
        self.label_options = {
            name: tuple(value["true"]) for name, value in stats.items()
        }
        self.label_options_groups = {
            group: {name: tuple(v["true"]) for name, v in members.items()}
            for group, members in self.label_options_weights_groups.items()
        }

        def weight_row(value):
            options = tuple(value["true"])
            return {
                "true": tuple(value["true"][o] for o in options),
                "false": tuple(value["false"][o] for o in options),
            }

        self.label_weights = {name: weight_row(v) for name, v in stats.items()}
        self.label_weights_groups = {
            group: {name: weight_row(v) for name, v in members.items()}
            for group, members in self.label_options_weights_groups.items()
        }

    # -- frame-label tensors ------------------------------------------

    def _rasterize(self, tier: dict[str, np.ndarray]) -> np.ndarray:
        """Interval tier -> per-embedding-frame string array (slice
        assignment per interval; later intervals win ties)."""
        period = self.embedding_size / self.sampling_rate
        t0 = float(tier["start"][0])
        t1 = float(tier["end"][-1])
        frames = int((t1 - t0) // period)
        values = np.full(frames, "none", dtype=object)
        starts = (tier["start"] // period).astype(int)
        ends = np.minimum((tier["end"] // period).astype(int), frames)
        for lo, hi, text in zip(starts, ends, tier["text"]):
            values[lo:hi] = text
        return values

    def _encode(self, name: str, values: np.ndarray) -> np.ndarray:
        """String frame values -> class-id tensor via the option tables."""
        options = self.label_options[name]
        lut = {option: k for k, option in enumerate(options)}
        return np.fromiter((lut[v] for v in values), np.int64, len(values))

    def _fresh_frame_labels(self, row: int) -> dict:
        tiers = self.index.interval_tiers(row)
        rasters = {name: self._rasterize(tier) for name, tier in tiers.items()}
        n_frames = min(len(r) for r in rasters.values())
        utt = self.index.utterance_labels(row)
        out: dict = {}
        for group, names in TAXONOMY.items():
            out[group] = {}
            for name in names:
                if name in rasters:
                    values = rasters[name][:n_frames]
                else:  # utterance-constant labels broadcast over frames
                    values = np.full(n_frames, utt[name], dtype=object)
                out[group][name] = self._encode(name, values)
        return out

    def cached_frame_labels(self, row: int) -> dict:
        return do_with_pickle_cache(
            lambda: self._fresh_frame_labels(row),
            str(self._frame_label_dir / f"{row}.pickle"),
        )

    def create_pickle_label(self, row: int) -> None:
        """Warm one row's frame-label cache (cli/warm_cache fan-out)."""
        create_pickle_cache(
            lambda: self._fresh_frame_labels(row),
            str(self._frame_label_dir / f"{row}.pickle"),
        )

    # -- item access ---------------------------------------------------

    def _scan_row(self, position: int) -> int:
        """Golden-ratio low-discrepancy position->row map when a size cap
        subsamples the corpus (deterministic validation subsets)."""
        n = len(self.index)
        if self.size >= n:
            return position
        return (int(n / _GOLDEN) * position) % n

    def __len__(self) -> int:
        return min(len(self.index), self.size)

    def __getitem__(self, position: int):
        rng = random.Random()
        if self.deterministic:
            rng.seed(position)
        row = self._scan_row(position)
        wav, path, frames, utt = self._crop(row, rng)
        if self.should_augment:
            wav, frames, utt = self._apply_augmentations(wav, frames, utt, rng)
        return wav, path, frames, utt

    def _load_audio(self, row: int) -> tuple[np.ndarray, str]:
        path = get_path_by_glob(self.data_dir, self.index.table["wav"][row])
        if self.disable_wavs:
            return np.zeros((self.segment_length,), np.float32), str(path)
        audio, sr = load_wav(path)
        if sr != self.sampling_rate:
            raise ValueError(f"{path}: {sr} Hz != dataset rate {self.sampling_rate}")
        return audio[0].astype(np.float32), str(path)

    def _crop(self, row: int, rng: random.Random):
        """Random segment_length crop aligned to the embedding grid; short
        items get random-split zero padding on both tensors."""
        wav, path = self._load_audio(row)
        frames = {
            group: {name: arr for name, arr in members.items()}
            for group, members in self.cached_frame_labels(row).items()
        }

        emb = self.embedding_size
        seg_frames = self.segment_length // emb
        n_frames = min(
            wav.shape[0] // emb,
            min(arr.shape[0] for members in frames.values() for arr in members.values()),
        )
        wav = wav[: n_frames * emb]

        if n_frames >= seg_frames:
            first = rng.randint(0, n_frames - seg_frames)
            cut_wav = wav[first * emb : (first + seg_frames) * emb]
            cut = lambda arr: arr[:n_frames][first : first + seg_frames]  # noqa: E731
        else:
            lead = rng.randint(0, seg_frames - n_frames)
            tail = seg_frames - n_frames - lead
            cut_wav = np.pad(wav, (lead * emb, tail * emb))
            cut = lambda arr: np.pad(arr[:n_frames], (lead, tail))  # noqa: E731
        frames = {
            group: {name: cut(arr) for name, arr in members.items()}
            for group, members in frames.items()
        }

        utt_values = self.index.utterance_labels(row)
        utt = {
            group: {n: utt_values[n] for n in names if n in utt_values}
            for group, names in TAXONOMY.items()
        }
        return cut_wav, path, frames, utt

    # -- augmentation ---------------------------------------------------

    def _apply_augmentations(self, wav, frames, utt, rng: random.Random):
        """Walk the probability tree once per augmentor; successful draws
        transform the waveform and stamp their label on every frame of the
        item (augmentations apply to the whole crop, ref :478-517)."""
        n_frames = next(
            arr.shape[0] for members in frames.values() for arr in members.values()
        )
        roll_any = self.aug_probs["prob"] > rng.random()
        for aug in self.aug_options:
            value = "disabled"
            if roll_any and self.aug_probs["sub_probs"][aug]["prob"] > rng.random():
                value = rng.choice(self.aug_options[aug])
                _, wav, value = self.augmentors[aug](
                    rng, None, frames, wav, value, self.disable_wavs
                )
            for group, names in AUGMENTATION_TAXONOMY.items():
                if aug in names:
                    frames[group][aug] = self._encode(
                        aug, np.full(n_frames, value, dtype=object)
                    )
                    utt[group][aug] = value
        return wav, frames, utt

    # -- batching --------------------------------------------------------

    def batches(self, batch_size, shuffle=True, drop_last=True, seed=1234,
                process_index=0, process_count=1):
        """Stacked host batches: ``{'audio': (B, T) f32, 'time_labels':
        {group: {label: (B, T_emb) int64}}, 'paths': [...],
        'grouped_labels': [...]}`` — static shapes; strided per-host
        sharding (host ``i`` of ``N`` takes positions i, i+N, ... of one
        shared shuffle, the DistributedSampler replacement)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        order = order[process_index::process_count]
        usable = len(order) - (len(order) % batch_size if drop_last else 0)
        for at in range(0, usable, batch_size):
            items = [self[int(p)] for p in order[at : at + batch_size]]
            head = items[0][2]
            yield {
                "audio": np.stack([wav for wav, *_ in items]).astype(np.float32),
                "time_labels": {
                    group: {
                        name: np.stack([item[2][group][name] for item in items])
                        for name in head[group]
                    }
                    for group in head
                },
                "paths": [path for _, path, *_ in items],
                "grouped_labels": [utt for *_, utt in items],
            }
