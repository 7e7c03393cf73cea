"""The closed loops a cell's traffic drives: one client sends file after
file, the next once the last returned.

``CompressLoop`` runs ``lbzip2_tpu_torch.codec.encoder.compress(data,
level, device=...)`` over the cell's files; ``DecompressLoop`` runs
``lbzip2_tpu_torch.parallel.decode.decompress_parallel(stream,
device=...)`` over their streams, which the set-up made with libbzip2,
an encoder that is not the port.  The traffic file's ``loop`` names the
class.  The port is imported when a loop is made, after the run has set
the configuration's switches in its environment.
"""

from __future__ import annotations

import bz2
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

from gpubench import corpus, instrument, reference


@dataclasses.dataclass
class Window:
    """What the window did: every call's answer (file index, bytes or
    None when the call raised; an answer equal to an earlier one of the
    same file is that earlier object, so the window holds one copy), the
    port's statistics and the seconds of each call, the bytes the calls
    processed, the wall time from the first call to the return of the
    last, and each call's host readings (``host_sample``)."""

    answers: list
    calls: list
    call_s: list
    nbytes: int
    wall_s: float
    errors: list
    host: list = dataclasses.field(default_factory=list)


def host_sample() -> tuple:
    """This process's CPU seconds, and the machine's busy and stolen
    seconds summed over its cores (``/proc/stat``; None where there is
    none): read around each call, to tell a slow call that waited on
    other tenants of the host from one that did more work."""
    cpu = time.process_time()
    try:
        with open("/proc/stat") as fh:
            f = [int(x) for x in fh.readline().split()[1:]]
    except (OSError, ValueError):
        return cpu, None, None
    hz = os.sysconf("SC_CLK_TCK")
    idle = f[3] + f[4]
    return cpu, (sum(f[:8]) - idle) / hz, (f[7] if len(f) > 7 else 0) / hz


class CompressLoop:
    metric = "compress_MBps"

    def __init__(self, config: dict, traffic: dict, device: str,
                 dry: bool):
        from lbzip2_tpu_torch import native
        from lbzip2_tpu_torch.codec import encoder

        self.native, self.encoder = native, encoder
        self.config, self.traffic = config, traffic
        self.device, self.dry = device, dry
        self.level = int(config["level"])
        # the configuration's effort, unless a control sets another
        self.compress_kwargs = {"cluster_factor":
                                int(config["cluster_factor"])}
        self.files: list = []

    def setup(self, files: list) -> dict:
        """The host library as it ships (built on a checkout's first run,
        no profile), the device engine at the configuration's bucket, one
        warm compress of the traffic's warm blocks, and the pool drained;
        each step's seconds."""
        self.files = files
        t: dict = {}
        t0 = time.time()
        if self.native.get_lib() is None:
            raise RuntimeError("the port's host C library did not load")
        t["host_library_s"] = time.time() - t0
        t0 = time.time()
        bucket = int(self.config["dry_bucket" if self.dry else "bucket"])
        self.encoder.warm_device(rows=(1,) if self.dry else
                                 (int(self.config["batch_rows"]),),
                                 bucket=bucket, device=self.device)
        t["warm_device_s"] = time.time() - t0
        t0 = time.time()
        warm = files[0].data[:int(self.traffic["warm_blocks"]) *
                             self.level * 100_000]
        self.encoder.compress(warm, self.level, device=self.device,
                              **self.compress_kwargs)
        self.encoder._GATE.wait_idle(max_inflight=0)
        if self.encoder._GATE.inflight:
            raise RuntimeError("batches of the warm compress still in flight")
        t["warm_compress_s"] = time.time() - t0
        return t

    def call(self, k: int) -> bytes:
        return self.encoder.compress(self.files[k].data, self.level,
                                     device=self.device,
                                     **self.compress_kwargs)

    def stats(self) -> dict:
        return self.encoder.last_stats

    def spans(self, rec: instrument.Recorder):
        return instrument.compress_spans(self.encoder, rec)

    def device_bytes(self, window: Window, rec: instrument.Recorder) -> int:
        """The rows' bytes in and the device stages' bytes out, or 0
        (nothing to read) where either side counted none."""
        return rec.device_bytes if rec.in_bytes and rec.out_bytes else 0

    def judge(self, window: Window) -> dict:
        return reference.judge_compress(window.answers, self.files,
                                        self.level)


class DecompressLoop:
    metric = "decompress_MBps"

    def __init__(self, config: dict, traffic: dict, device: str,
                 dry: bool):
        from lbzip2_tpu_torch import native
        from lbzip2_tpu_torch.parallel import decode

        self.native, self.decode = native, decode
        self.config, self.traffic = config, traffic
        self.device, self.dry = device, dry
        self.files: list = []
        self.streams: list[bytes] = []

    def setup(self, files: list) -> dict:
        """Each file compressed by libbzip2 at the traffic's level (in
        threads: the module releases the interpreter lock), the host
        library as it ships, and one warm decompress of the first
        stream."""
        self.files = files
        t: dict = {}
        t0 = time.time()
        level = int(self.traffic["encoder_level"])
        with ThreadPoolExecutor(max_workers=len(files)) as ex:
            self.streams = list(ex.map(
                lambda f: bz2.compress(f.data, level), files))
        t["encode_s"] = time.time() - t0
        t0 = time.time()
        if self.native.get_lib() is None:
            raise RuntimeError("the port's host C library did not load")
        t["host_library_s"] = time.time() - t0
        t0 = time.time()
        for k in range(int(self.traffic["warm_files"])):
            self.call(k)
        t["warm_decompress_s"] = time.time() - t0
        return t

    def call(self, k: int) -> bytes:
        return self.decode.decompress_parallel(self.streams[k],
                                               device=self.device)

    def stats(self) -> dict:
        return self.decode.last_stats

    def spans(self, rec: instrument.Recorder):
        return instrument.decompress_spans(self.decode, rec)

    def device_bytes(self, window: Window, rec: instrument.Recorder) -> int:
        """Each stream's Huffman payload in (its bytes) and its blocks' n
        out (the files' bytes after RLE1), for every call of the
        window."""
        rle1 = {k: corpus.rle1_bytes(self.files[k].data)
                for k in {k for k, _ in window.answers}}
        return sum(len(self.streams[k]) + rle1[k] for k, _ in window.answers)

    def judge(self, window: Window) -> dict:
        return reference.judge_decompress(window.answers, self.files)


LOOPS = {"compress": CompressLoop, "decompress": DecompressLoop}


def run_window(loop, seconds: float, call=None) -> Window:
    """Calls, file after file in order, until ``seconds`` have passed;
    the window closes when the last call returns.  ``call`` stands in
    for ``loop.call`` (the tests' faults)."""
    call = call or loop.call
    n = len(loop.files)
    answers, calls, call_s, errors, host = [], [], [], [], []
    first: dict = {}
    nbytes = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % n
        h0 = host_sample()
        t1 = time.perf_counter()
        try:
            out = call(k)
        except Exception as e:  # noqa: BLE001 — a failed call is counted
            errors.append(f"{type(e).__name__}: {e}")
            out = None
        call_s.append(time.perf_counter() - t1)
        h1 = host_sample()
        host.append(tuple(None if a is None else b - a
                          for a, b in zip(h0, h1)))
        if out is not None:
            prev = first.setdefault(k, out)
            if prev is not out and prev == out:
                out = prev
        answers.append((k, out))
        calls.append(loop.stats())
        nbytes += len(loop.files[k].data)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return Window(answers, calls, call_s, nbytes, time.perf_counter() - t0,
                  errors, host)
