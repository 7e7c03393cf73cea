"""The files a cell makes: the same bytes for the same seed, nothing read
outside the checkout, and bzip2's RLE1 length counted right."""

import builtins
import pathlib

import numpy as np
import pytest

from gpubench import corpus, spec

TRAFFIC = spec.load_json(spec.ROOT, "traffic", "files-256m")
SMALL = 300_000


def test_same_seed_same_bytes():
    a = corpus.make_files(TRAFFIC, 2**31 + 12345, SMALL)
    b = corpus.make_files(TRAFFIC, 2**31 + 12345, SMALL)
    assert [f.sha256 for f in a] == [f.sha256 for f in b]
    assert len({f.sha256 for f in a}) == TRAFFIC["distinct_files"]
    assert all(len(f.data) == SMALL for f in a)


@pytest.mark.parametrize("seed", [0, 1, -7, 2**64 + 3])
def test_seeds_differ(seed):
    a = corpus.make_file(TRAFFIC, seed, 0, corpus.text_class(), SMALL)
    b = corpus.make_file(TRAFFIC, seed + 1, 0, corpus.text_class(), SMALL)
    assert a.sha256 != b.sha256


def test_reads_nothing_outside_the_checkout(monkeypatch):
    root = spec.ROOT.resolve()
    seen = []
    real_open = builtins.open

    def spy(file, *args, **kwargs):
        seen.append(pathlib.Path(file).resolve())
        return real_open(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    corpus.make_files(TRAFFIC, 5, SMALL)
    assert seen
    assert all(p.is_relative_to(root / "lbzip2_tpu") for p in seen), \
        [p for p in seen if not p.is_relative_to(root)]


def test_classes_at_their_shares():
    """Each class is its share of the file plus the pad, before the
    pages are drawn: the XML pages come at that share."""
    size, pad = 4_000_000, TRAFFIC["sources"]["pad_bytes"]
    f = corpus.make_file(TRAFFIC, 9, 0, corpus.text_class(), size)
    pages = np.frombuffer(f.data, np.uint8)[:3_997_696].reshape(-1, 4096)
    xml = np.mean([p.tobytes().count(b"<rec id=") > 0 for p in pages])
    want = (size * TRAFFIC["shares"]["xml"] + pad) / (
        size + len(TRAFFIC["shares"]) * pad)
    assert abs(xml - want) < 0.03


def _rle1_plain(data: bytes) -> int:
    out, i = 0, 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i]:
            j += 1
        q, r = divmod(j - i, 255)
        out += 5 * q + (5 if r >= 4 else r)
        i = j
    return out


@pytest.mark.parametrize("seed", range(4))
def test_rle1_bytes(seed):
    rng = np.random.default_rng(seed)
    data = rng.choice(np.array([0, 0, 0, 1, 2], np.uint8),
                      int(rng.integers(1, 4000))).tobytes()
    data += b"\x07" * int(rng.integers(0, 900)) + b"\x01" * 4
    assert corpus.rle1_bytes(data, chunk=1 << 30) == _rle1_plain(data)
