"""Batch prefetch onto the device: the port's counterpart of
``geossl_tpu/parallel/mesh.py``'s ``prefetch``, through which every
driver's training and eval loop takes its batches.

The rest of the JAX module (device meshes, batch sharding, the gather of
sharded outputs) serves multi-device runs, which the port does not run yet
(``ROADMAP.md`` queue 1 item 5); it waits for that item.
"""

from __future__ import annotations

import queue
import threading

import torch

# how long the producer waits on a full queue before it looks again whether
# the consumer has stopped
_PUT_POLL_S = 0.1


def prefetch(batch_iterator, device, size: int = 2):
    """Yield the batches of ``batch_iterator`` on ``device``, in order,
    packed and uploaded up to ``size`` batches ahead.

    A daemon thread drains the iterator (so the C++ packer, which releases
    the interpreter lock, runs beside the training loop), pins each batch
    on CUDA and uploads it with ``non_blocking`` on the consumer's current
    stream: the host never waits for a copy, and the caching host allocator
    keeps each pinned block until its copy is done. On the CPU the thread
    runs the iterator and the batches stay where they are. The thread is
    the iterator's only consumer, so its RNG draws (shuffle, masking) are
    the plain loop's. An exception in the producer is raised here; closing
    this generator (``close()``, a ``break``, garbage collection) stops the
    thread within ``_PUT_POLL_S`` of its current batch.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.current_stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has stopped
        # (otherwise the thread would block forever on a full queue)
        while not stop.is_set():
            try:
                q.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batch_iterator:
                if cuda:
                    with torch.cuda.stream(stream):
                        batch = batch.pin_memory().to(device,
                                                      non_blocking=True)
                if not put(batch):
                    return
        except BaseException as e:  # raised on the consumer's side
            put(e)
            return
        put(end)

    thread = threading.Thread(target=producer, name="geossl-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
