"""The files a cell compresses or decompresses, made from the seed.

A frozen copy of the corpus arithmetic of ``bench_torch.py`` (its
``text_class``, ``corpus_parts`` and ``build_corpus``): classes at their
shares, each class's source repeated to its share of the file plus a
pad, the whole shuffled in 4 KiB pages so that every 900 kB block sees a
mix.  Two departures, both so that every checkout makes the same bytes
on every machine:

- ``bench_torch.py``'s ELF class read the machine's own libraries, and
  the checkout holds no binary bytes to stand in for it, so it is left
  out: the other three classes keep ``bench.py``'s proportions (text 50,
  XML 15, random 10), scaled up to fill the file;
- the XML records draw their words and values in arrays, not one record
  at a time (the same records, drawn in another order).

The text class is the frozen JAX package's source files, read as bytes
and never imported.  Nothing outside the checkout is read.  The traffic
file (``traffic/<name>.json``) gives the sizes and shares.

Any other name under ``shares`` is a class of its own,
``classes/<name>.py`` beside ``configs/``, ``traffic/`` and
``metrics/``, found by name (``spec.data_class``): its ``make(traffic,
rng, text, nbytes)`` returns the class's share of the file.  With
``"page_bytes": null`` the classes follow one another in the order of
``shares``, unshuffled, so that data whose order matters (the versions
of an archive) keeps it.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gpubench import spec

# The text class: the JAX package's Python and C sources, each pattern's
# matches in sorted order.  That package is frozen, so the class is the
# same in every checkout.
TEXT_GLOBS = ("lbzip2_tpu/**/*.py", "lbzip2_tpu/native/*.c")

# The classes built here; any other name is a module under classes/.
BUILT_IN = ("text", "xml", "random")

@dataclasses.dataclass(frozen=True)
class File:
    """One file of a cell: its index among the cell's distinct files, its
    bytes and their sha256."""

    index: int
    data: bytes
    sha256: str


def text_class(root: pathlib.Path = spec.ROOT) -> bytes:
    """Every file of TEXT_GLOBS under ``root``, concatenated."""
    out = []
    for pat in TEXT_GLOBS:
        for f in sorted(glob.glob(str(root / pat), recursive=True)):
            with open(f, "rb") as fh:
                out.append(fh.read())
    blob = b"".join(out)
    if not blob:
        raise RuntimeError(f"corpus: the text class is empty under {root}")
    return blob


def words_of(text: bytes) -> list[bytes]:
    """The words of the XML class: bench_torch.py's rule."""
    words = [w for w in text.split(b" ") if 2 < len(w) < 16][:4096]
    if not words:
        raise RuntimeError("corpus: the text class has no words")
    return words


def xml_records(words: list[bytes], nbytes: int,
                rng: np.random.Generator) -> bytes:
    """bench_torch.py's XML-like records, ids from 0, until ``nbytes``."""
    recs: list[bytes] = []
    total = i = 0
    while total < nbytes:
        m = 65536
        ws = rng.integers(len(words), size=m)
        vs = rng.integers(1 << 30, size=m)
        for w, v in zip(ws.tolist(), vs.tolist()):
            rec = b"<rec id=\"%d\"><k>%s</k><v>%d</v></rec>\n" % (
                i, words[w], v)
            recs.append(rec)
            total += len(rec)
            i += 1
            if total >= nbytes:
                break
    return b"".join(recs)


def seed_sequence(seed: int, index: int) -> np.random.SeedSequence:
    """File ``index``'s draw of ``seed``: any whole number, negative or
    past 64 bits too, gives its own sequence."""
    return np.random.SeedSequence([seed % (1 << 64), seed >> 64 & 0xFFFF,
                                   index])


def make_file(traffic: dict, seed: int, index: int, text: bytes,
              nbytes: int | None = None,
              root: pathlib.Path = spec.ROOT) -> File:
    """File ``index`` of ``seed``: ``traffic["file_bytes"]`` bytes (or
    ``nbytes``) of the classes at ``traffic["shares"]``, each class's
    source repeated to its share plus ``pad_bytes``, shuffled in pages of
    ``page_bytes`` (in the order of ``shares`` where it is null).

    One generator draws, in this order: the XML records and the random
    bytes, where ``sources`` gives their sizes; each class module's
    share, in the order of ``shares``; the pages' permutation."""
    size = int(nbytes if nbytes is not None else traffic["file_bytes"])
    src = traffic["sources"]
    pad = int(src["pad_bytes"])
    rng = np.random.default_rng(seed_sequence(seed, index))
    sources = {"text": text}
    if "xml_bytes" in src:
        sources["xml"] = xml_records(words_of(text), int(src["xml_bytes"]),
                                     rng)
    if "random_bytes" in src:
        sources["random"] = rng.integers(0, 256, int(src["random_bytes"]),
                                         dtype=np.uint8).tobytes()
    wants = {name: int(size * float(share)) + pad
             for name, share in traffic["shares"].items()}
    for name, want in wants.items():
        if name in BUILT_IN:
            continue
        made = spec.data_class(name, root).make(traffic, rng, text, want)
        if len(made) != want:
            raise ValueError(f"corpus: class {name!r} made {len(made)} "
                             f"bytes, not {want}")
        sources[name] = made
    blob = np.concatenate([np.resize(np.frombuffer(sources[name], np.uint8),
                                     want) for name, want in wants.items()])
    page = traffic["page_bytes"]
    if page is not None:
        npages = blob.size // int(page)
        pages = blob[:npages * int(page)].reshape(npages, int(page))
        blob = pages[rng.permutation(npages)].reshape(-1)
    if blob.size < size:
        raise ValueError("corpus: the shares and pads leave the file short")
    data = blob[:size].tobytes()
    return File(index, data, hashlib.sha256(data).hexdigest())


def make_files(traffic: dict, seed: int, nbytes: int | None = None,
               root: pathlib.Path = spec.ROOT) -> list[File]:
    """The cell's ``distinct_files`` files of ``seed``, made in threads
    (numpy and hashlib release the interpreter lock)."""
    text = text_class(root)
    n = int(traffic["distinct_files"])
    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(lambda k: make_file(traffic, seed, k, text,
                                               nbytes, root), range(n)))


def rle1_bytes(data: bytes, chunk: int = 8 << 20) -> int:
    """Length of ``data`` after bzip2's first run-length stage (a run of
    4 to 255 equal bytes becomes 4 bytes and a count; longer runs split
    at 255), counted in chunks of ``chunk`` bytes, a run across a chunk
    edge counted as two: the bytes a decoder's inverse BWT writes."""
    arr = np.frombuffer(data, np.uint8)
    total = arr.size
    for a in range(0, arr.size, chunk):
        c = arr[a:a + chunk]
        # lanes equal to the next one; a run of L bytes holds L - 1 of
        # them, consecutive
        eq = np.flatnonzero(c[1:] == c[:-1])
        if not eq.size:
            continue
        breaks = np.flatnonzero(np.diff(eq) != 1)
        counts = np.diff(np.concatenate(([-1], breaks, [eq.size - 1])))
        runs = counts[counts >= 3] + 1
        q, r = np.divmod(runs, 255)
        total += int((5 * q + np.where(r >= 4, 5, r) - runs).sum())
    return total
