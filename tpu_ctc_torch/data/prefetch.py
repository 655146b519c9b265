"""Host -> device batch prefetching on a thread.

Counterpart of ``tpu_ctc.data.prefetch``: a daemon thread takes
``(cursor, Batch)`` from the loader (the lazy manifest's frontend runs
there, or in the manifest's pool of processes, whose items the thread
awaits), turns the batch's arrays into tensors on the device and queues
them, ``size`` batches ahead of the consumer.

On a card the thread pins each array and copies it with
``non_blocking=True`` on a side stream, then records an event.  The
consumer makes its current stream wait on that event and marks each tensor
as used by that stream (``record_stream``), so the caching allocator does
not hand the memory to another tensor while the step still reads it.  On
the CPU the thread only converts the arrays.  An exception in the thread is
raised in the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tpu_ctc_torch.data.bucketing import cut_labels

_END = object()


def prefetch_to_device(iterator: Iterator, device, size: int = 2,
                       select=None) -> Iterator:
    """Wrap an iterator of ``(cursor, Batch)``; yield ``(cursor, Batch,
    {name: tensor on device})`` with the arrays of
    ``train.loop.batch_to_device_dict``, the labels cut to the global
    batch's width (``bucketing.cut_labels``, as
    ``train.step.batch_to_tensors`` cuts them), then passed through
    ``select`` (this rank's block of them, ``train.step.local_batch``)
    before the copy when it is given.  The cut comes first so that every
    rank of a mesh gets the same label width, and so the same graph key
    (``train.graphs.shape_key``), at every step.  The cursor is the
    yielded batch's own, so a checkpoint taken while it is consumed
    resumes at it.  Closing the returned iterator stops the thread and
    waits for it to end."""
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            stream = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
            for cursor, batch in iterator:
                arrays = cut_labels(batch_to_device_dict(batch))
                if select is not None:
                    arrays = select(arrays)
                if stream is None:
                    dev = {k: torch.as_tensor(np.asarray(v), device=device)
                           for k, v in arrays.items()}
                    event = None
                else:
                    with torch.cuda.stream(stream):
                        dev = {k: torch.from_numpy(np.ascontiguousarray(v))
                               .pin_memory().to(device, non_blocking=True)
                               for k, v in arrays.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                if not put((cursor, batch, dev, event)):
                    return
        except Exception as e:  # raised again in the consumer
            err.append(e)
        finally:
            # a loader stopped mid-epoch tells the ranks it exchanges rows
            # with (``BucketedLoader`` with an exchange), here in its thread
            if hasattr(iterator, "close"):
                iterator.close()
            put(_END)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            cursor, batch, dev, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in dev.values():
                    t.record_stream(current)
            yield cursor, batch, dev
    finally:
        stop.set()
        thread.join()   # its loader's collectives end before the caller's
