"""Data loading (counterpart of flexflow_tpu/runtime/dataloader.py).

`SingleDataLoader` holds one input's whole numpy dataset and cuts it into
batches (shuffled per epoch by `np.random.RandomState(seed)`, as the
reference's); `FileDataLoader` memory-maps a .npy file and gathers its
batches on a native worker thread (csrc/ffloader.cc, shuffled by the
worker's own generator, as the reference's). For the same seed both give
the reference's batches in the reference's order.

`PrefetchLoader` zips several loaders into fit's batches and keeps one
batch ahead. On the card batch t+1 is copied while step t runs: its host
arrays go into pinned buffers (the caching host allocator keeps a buffer
until its copy is done) and to the card with non_blocking copies on a
side stream; the step's stream waits on an event recorded after them,
and `record_stream` tells the device allocator that the step's stream
uses the batch, so its memory is not handed out again before that
stream's work on it is done. Nothing here waits for the card. On the CPU
the same loop runs with no streams.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


class SingleDataLoader:
    """One tensor's dataset and its batches (the reference's API:
    num_samples, num_batches, next_batch, reset)."""

    def __init__(self, ffmodel, input_tensor, full_array: np.ndarray,
                 batch_size: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0):
        self.ffmodel = ffmodel
        self.tensor = input_tensor
        self.data = np.ascontiguousarray(full_array)
        self.batch_size = batch_size or ffmodel.config.batch_size
        self.shuffle = shuffle
        self._rs = np.random.RandomState(seed)
        self._order = np.arange(len(self.data))
        self._idx = 0

    @property
    def num_samples(self) -> int:
        return len(self.data)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self._idx = 0
        if self.shuffle:
            self._rs.shuffle(self._order)

    def next_batch(self) -> np.ndarray:
        if self._idx + self.batch_size > self.num_samples:
            raise StopIteration
        sel = self._order[self._idx:self._idx + self.batch_size]
        self._idx += self.batch_size
        return self.data[sel]


class PrefetchLoader:
    """Zip of several loaders with one batch of prefetch: while step t
    runs, batch t+1 is already on its way to the device."""

    def __init__(self, ffmodel, loaders: Sequence):
        self.ffmodel = ffmodel
        self.loaders = list(loaders)

    def __iter__(self) -> Iterator[List[torch.Tensor]]:
        for ld in self.loaders:
            ld.reset()
        device = self.ffmodel.executor.device
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)
        try:
            nxt = _put(self._local(), device, stream)
        except StopIteration:
            return
        while True:
            cur = nxt
            try:
                nxt = _put(self._local(), device, stream)
            except StopIteration:
                nxt = None
            yield _ready(cur)
            if nxt is None:
                return

    def __len__(self) -> int:
        return min(ld.num_batches for ld in self.loaders)

    def _local(self) -> List[np.ndarray]:
        """The loaders' next global batch (the inputs, then the labels),
        cut to this rank's piece on a process mesh: each rank copies
        only its rows to its card."""
        arrays = [ld.next_batch() for ld in self.loaders]
        return self.ffmodel.executor.local_batch(arrays, labels=True)


def _put(arrays, device: torch.device, stream) -> tuple:
    """(tensors, event): the host arrays as tensors, on the CPU sharing
    their memory (event None); on the card copied from pinned buffers on
    `stream`, the event recorded after the copies."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if stream is None:
        return host, None
    with torch.cuda.stream(stream):
        out = [h.pin_memory().to(device, non_blocking=True) for h in host]
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _ready(batch) -> List[torch.Tensor]:
    """A batch made by _put, usable on the current stream: the stream
    waits for the copies, and each tensor is marked as used by it."""
    tensors, done = batch
    if done is not None:
        cur = torch.cuda.current_stream(tensors[0].device)
        cur.wait_event(done)
        for t in tensors:
            t.record_stream(cur)
    return tensors


class FileDataLoader:
    """A memory-mapped .npy dataset whose batches a native worker thread
    (csrc/ffloader.cc) gathers off the GIL into a ring of buffers while
    the step runs; the SingleDataLoader surface, so PrefetchLoader zips
    it with others."""

    def __init__(self, ffmodel, input_tensor, path: str,
                 batch_size: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0):
        from flexflow_tpu_torch import native

        self._lib = native.get_loader_lib()
        # the npy header is parsed here; the C side gets (offset, bytes a
        # sample)
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            reader = (np.lib.format.read_array_header_1_0
                      if version == (1, 0)
                      else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = reader(f)
            offset = f.tell()
        if fortran:
            raise ValueError("fortran-order npy files are not supported")
        self.dtype = dtype
        self.sample_shape = tuple(shape[1:])
        self._n = int(shape[0])
        sample_bytes = int(dtype.itemsize
                           * np.prod(self.sample_shape or (1,)))
        self._h = self._lib.ffl_open(path.encode(), sample_bytes, self._n,
                                     offset)
        if not self._h:
            raise OSError(f"ffl_open failed for {path!r}")
        self.ffmodel = ffmodel
        self.tensor = input_tensor
        self.batch_size = batch_size or ffmodel.config.batch_size
        self._configured_batch = None
        self._shuffle = shuffle
        self._seed = seed
        self._produced = 0

    @property
    def num_samples(self) -> int:
        return self._n

    @property
    def num_batches(self) -> int:
        return self._n // self.batch_size

    def reset(self):
        if self._configured_batch != self.batch_size:
            self._lib.ffl_config(self._h, self.batch_size,
                                 1 if self._shuffle else 0, self._seed)
            self._configured_batch = self.batch_size
        self._lib.ffl_reset(self._h)
        self._produced = 0

    def next_batch(self) -> np.ndarray:
        if self._configured_batch != self.batch_size:
            # batch_size changed since the worker was configured: its
            # buffers are the old size
            self.reset()
        out = np.empty((self.batch_size, *self.sample_shape), self.dtype)
        if not self._lib.ffl_next(self._h, out.ctypes.data, self._produced):
            raise StopIteration
        self._produced += 1
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ffl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
