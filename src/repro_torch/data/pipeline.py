"""Prefetching host data pipeline (the port of `repro.data.pipeline`).

Each host materializes only its data-parallel shard of the global batch
(deterministically, from the step index), moves it to the device as torch
tensors, and prefetches `prefetch_depth` steps ahead on a worker thread.
Restart-from-step-N is exact: the pipeline has no state beyond N.  On one
card there are no shardings: every array goes to `device`.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from .synthetic import SyntheticTokenDataset


class DataPipeline:
    def __init__(self, dataset: SyntheticTokenDataset, global_batch: int,
                 host_index: int = 0, host_count: int = 1,
                 prefetch_depth: int = 2, device="cuda"):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.host_index = host_index
        self.prefetch_depth = prefetch_depth
        self.device = torch.device(device)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        return self.dataset.batch(
            step, self.host_index * self.local_batch, self.local_batch)

    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.host_batch(step).items()}

    def __call__(self, start_step: int = 0
                 ) -> Iterator[Dict[str, torch.Tensor]]:
        """Prefetching iterator from `start_step` (exact resume point).  An
        error in the worker is raised here, at the batch it would have
        made."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    item = self.device_batch(step)
                except Exception as exc:  # handed to the consumer
                    item = exc
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
