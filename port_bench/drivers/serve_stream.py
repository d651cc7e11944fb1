"""Driver of a closed-loop offline stream of whole rooms through
``ResidentSceneServer.predict_scenes``: a user labelling a scan set.

Set-up makes the pool of rooms from the seed, builds the model with the
benchmark's weights (their BatchNorm running statistics those of the
first pool room's first chunks, as the reference computes them; BatchNorm
then folded into the convolutions, the serving copy), the server on the
reference's wire and grid (q16, 1.5 m cells, 0.2 m margins), and serves
every pool room once, so that each room size's buffers and kernels exist
before the window.  The window hands rooms from the pool in a seeded
random order, each a fresh copy, as fast as the server takes them, stops
taking rooms when its seconds are spent and drains.  A room's latency runs
from the moment the stream yields it to the moment its labels are yielded
back.  The traced stretch serves the whole pool once, in pool order, so
that it reads the same rooms in every run, however many the window took.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, Iterable, List

import numpy as np
import torch
from torch.profiler import record_function

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.eval.resident_serving import ResidentSceneServer
from pointcloud_segmentation_attention_tpu_torch.train.bn_fold import fold_batchnorm_for_inference
from port_bench.lib import common, rooms
from port_bench.lib.trace import WINDOW_SPAN
from port_bench.reference import serve as ref


class Driver:
    kind = "serve"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.batch, self.npoints = traffic["batch_size"], traffic["npoints"]
        self.extras: Dict = {}

    def setup(self) -> None:
        cfg, t, dev = self.cfg, self.traffic, self.device
        phases = self.extras.setdefault("setup_phases_s", {})
        with common.timed(phases, "rooms"):
            self.pool = rooms.make_rooms(self.seed, cfg["n_serve_scenes"], t["room_points"])
        with common.timed(phases, "model"):
            model = models.get_model(cfg["registry"], device=dev)
            self.weights = ref.calibrate_bn(
                common.make_weights({k: v.shape for k, v in model.state_dict().items()},
                                    self.seed, dev),
                cfg, self.pool[0], self.npoints, t["bn_calibration_chunks"], dev)
            model.load_state_dict(self.weights)
        model, _ = fold_batchnorm_for_inference(model.eval())
        self.server = ResidentSceneServer(
            model, self.npoints, batch_size=self.batch, layout="q16",
            use_colors=cfg["use_colors"], use_normals=cfg["use_normals"],
            pipeline_depth=t["pipeline_depth"], chunk_size=ref.CHUNK, margin=ref.MARGIN,
            device=dev)
        rng = np.random.Generator(np.random.PCG64(common.mix(self.seed, 404)))
        self._order = (int(i) for _ in itertools.count() for i in rng.permutation(len(self.pool)))
        with common.timed(phases, "warmup_rooms"):
            for _ in self.server.predict_scenes(self._fresh(i, i) for i in range(len(self.pool))):
                pass
            self._sync()
        self.served: List = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _fresh(self, pool_index: int, request: int) -> Dict:
        room = self.pool[pool_index]
        return {"points": room["points"].copy(), "colors": room["colors"].copy(),
                "normals": room["normals"].copy(), "scene_name": request}

    def _serve(self, pool_indices: Iterable[int]) -> Dict:
        """Serve a fresh copy of each room of ``pool_indices``; returns the record."""
        handed, sent = {}, {}

        def stream():
            for request, i in enumerate(pool_indices):
                room = self._fresh(i, request)
                with record_function("bench.hand_room"):
                    handed[request] = time.perf_counter()
                    sent[request] = i
                yield room

        latencies, done, finished = [], [], []
        first = None
        it = self.server.predict_scenes(stream())
        while True:
            with record_function("bench.wait_labels"):
                try:
                    name, labels = next(it)
                except StopIteration:
                    break
            now = time.perf_counter()
            first = handed[0] if first is None else first
            latencies.append(now - handed[name])
            finished.append(now)
            done.append((sent[name], labels.astype(np.uint8)))
            last = now
        return {"handed": len(handed), "latencies": latencies, "done": done, "finished": finished,
                "wall_s": (last - first) if done else 0.0}

    def window(self, seconds: float) -> Dict:
        self._sync()
        t0 = time.perf_counter()
        rec = self._serve(itertools.takewhile(
            lambda _: time.perf_counter() - t0 < seconds, self._order))
        self.served = rec["done"]
        self.extras["rooms_each_5s"] = np.bincount(
            ((np.asarray(rec["finished"]) - t0) // 5.0).astype(np.int64)).tolist()
        vertices = sum(len(lab) for _, lab in rec["done"])
        lat_ms = np.asarray(rec["latencies"]) * 1e3
        self.extras.update(rooms_served=len(rec["done"]), vertices=vertices,
                           p50_ms=float(np.percentile(lat_ms, 50)) if len(lat_ms) else None)
        return {"rooms": len(rec["done"]), "wall_s": rec["wall_s"], "attempted": rec["handed"],
                "failed": rec["handed"] - len(rec["done"]),
                "pool_counts": np.bincount([i for i, _ in rec["done"]],
                                           minlength=len(self.pool)).tolist(),
                "metrics": {"serve_vertices_per_s": vertices / rec["wall_s"],
                            "serve_room_p95_ms": float(np.percentile(lat_ms, 95))}}

    def traced(self, prof_factory) -> Dict:
        self._sync()
        with prof_factory() as prof:
            with record_function(WINDOW_SPAN):
                rec = self._serve(range(len(self.pool)))
                self._sync()
        return {"prof": prof, "rooms": len(rec["done"]),
                "pool_counts": np.bincount([i for i, _ in rec["done"]],
                                           minlength=len(self.pool)).tolist()}

    def release(self) -> None:
        del self.server
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------------

    def sample(self) -> List[int]:
        """Requests to compare, drawn from the seed: the one with the most
        vertices, and others at random."""
        n = len(self.served)
        largest = int(np.argmax([len(lab) for _, lab in self.served]))
        rng = np.random.Generator(np.random.PCG64(common.mix(self.seed, 505)))
        rest = [int(i) for i in rng.permutation(n) if i != largest]
        return [largest] + rest[:self.traffic["check_rooms"] - 1]

    def reference_logits(self, pool_index: int, tf32: bool = False) -> torch.Tensor:
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            visits: Dict[str, float] = {}
            out = ref.room_logits(self.weights, self.cfg, self.pool[pool_index], self.npoints,
                                  self.batch, self.device, visits=visits)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        if not tf32:
            chunks = ref.chunk_count(ref.wire_q16(self.pool[pool_index], False, False)["points"],
                                     self.npoints)
            acc = self.extras.setdefault("visit_sum", {})
            for k, v in visits.items():
                acc[k] = acc.get(k, 0.0) + v
            self.extras["visit_chunks"] = self.extras.get("visit_chunks", 0) + chunks
        return out

    @staticmethod
    def gap(ref_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Per vertex: how far the logit of the given label lies below the
        reference's best."""
        return ref_logits.max(dim=1).values - ref_logits.gather(1, labels.long()[:, None])[:, 0]

    def readings(self, labels_of) -> Dict[str, float]:
        """``labels_of(request, ref_logits)`` gives the labels to judge; the
        widest gap over the sampled requests, over the reference logits'
        standard deviation."""
        widest, scale = 0.0, []
        for r in self.sample():
            pool_index, _ = self.served[r]
            logits = self.reference_logits(pool_index)
            labels = labels_of(r, logits)
            if labels is None or len(labels) != len(logits):
                return {"label_gap": float("inf")}
            widest = max(widest, float(self.gap(logits, labels).max()))
            scale.append(float(logits.std()))
        return {"label_gap": widest / float(np.mean(scale))}

    def check(self, limits: Dict[str, float]) -> List[common.Check]:
        def served(r, _):
            return torch.from_numpy(self.served[r][1]).to(self.device)

        r = self.readings(served)
        return [common.Check(k, r[k], limits[k]) for k in limits]
