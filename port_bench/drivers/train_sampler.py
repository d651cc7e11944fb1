"""Driver of a closed loop of sampler training steps: the path that
``train(config)`` composes for ``input='sampler'``.

Set-up makes the rooms in memory from the seed, keeps them on the card
(``ResidentScenes``), builds the model with the benchmark's weights,
Adam (``TrainState``) at the reference trainer's schedules, and the step
(``make_sampling_train_step``), fed a seeded permutation of the rooms a
pass through the program's prefetch thread.  The first three steps go
through that same step and feed and are held against the reference after
the window; further steps warm up.  The window issues steps until its
seconds are spent and ends at a ``synchronize()``; loss, accuracy and
confusion accumulate on the card and are fetched every ``fetch_every``
steps, the reference trainer's epoch.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data import pipeline
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler, schedules
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from port_bench.lib import common, rooms
from port_bench.lib.trace import WINDOW_SPAN
from port_bench.reference import train as ref

CHECKED_STEPS = 3


def scene_id_stream(seed: int, n_scenes: int, batch: int, pin: bool):
    """The trainer's scene-id feed: a seeded permutation of the rooms a pass,
    cut into batches (one resized to ``batch`` when there are fewer rooms).
    The seed is taken modulo 2**32, the range of numpy's legacy generator."""
    rng = np.random.RandomState(seed % 2 ** 32)
    n_full = n_scenes // batch * batch
    while True:
        order = rng.permutation(n_scenes)
        for i in range(0, max(n_full, batch), batch):
            t = torch.from_numpy(np.resize(order[i:i + batch], batch).astype(np.int32))
            yield {"scene_ids": t.pin_memory() if pin else t}


def _stream_generator(device, seed: int, *tags: int) -> torch.Generator:
    """The program's per-step random streams: (seed, 1000, step) for the
    sampler's draws, (seed, step) for dropout."""
    mixed = np.random.SeedSequence((seed,) + tags).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


class Driver:
    kind = "train"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.batch, self.npoints = traffic["batch_size"], traffic["npoints"]
        self.n_sched = traffic["schedule_n_train_scenes"]
        self.fetch_every = traffic["fetch_every"]
        self.extras: Dict = {}
        self._acc, self._since = None, 0

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        phases = self.extras.setdefault("setup_phases_s", {})
        with common.timed(phases, "rooms"):
            self.rooms = rooms.make_rooms(self.seed, cfg["n_train_scenes"],
                                          self.traffic["room_points"])
        with common.timed(phases, "resident_scenes"):
            self.scenes = device_sampler.ResidentScenes(
                self.rooms, device=dev, use_colors=cfg["use_colors"],
                use_normals=cfg["use_normals"])
        with common.timed(phases, "model"):
            model = models.get_model(cfg["registry"], device=dev)
            self.weights = common.make_weights(
                {k: v.shape for k, v in model.state_dict().items()}, self.seed, dev)
            model.load_state_dict(self.weights)
        lr = functools.partial(schedules.scannet_learning_rate, batch_size=self.batch,
                               n_train_scenes=self.n_sched)
        bn = functools.partial(schedules.scannet_bn_momentum, batch_size=self.batch,
                               n_train_scenes=self.n_sched)
        with common.timed(phases, "train_state"):
            self.state = TrainState(model, lr_schedule=lr)
            self.step_fn = device_sampler.make_sampling_train_step(
                self.scenes, self.npoints, bn_schedule=bn, num_classes=cfg["num_classes"],
                remat="none")
            self.feed = pipeline.prefetch(
                scene_id_stream(self.seed, len(self.rooms), self.batch, dev.type == "cuda"),
                depth=4)
        with common.timed(phases, "checked_steps"):
            self.checked = self._checked_steps()
        with common.timed(phases, "warmup_steps"):
            for _ in range(self.traffic["warmup_steps"]):
                self._step()
            self._fetch()
            self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self):
        batch = next(self.feed)
        _, m = self.step_fn(self.state, batch["scene_ids"], self.seed)
        self._acc = (m if self._acc is None else
                     {k: self._acc[k] + m[k] for k in ("loss", "accuracy", "confusion")})
        self._since += 1
        return batch, m

    def _fetch(self) -> int:
        """Fetch the accumulated loss, accuracy and confusion; returns the
        steps since the last fetch when their summed loss is not finite."""
        acc, since, self._acc, self._since = self._acc, self._since, None, 0
        if acc is None:
            return 0
        fetched = torch.cat([acc["loss"].reshape(1), acc["accuracy"].reshape(1),
                             acc["confusion"].reshape(-1)]).cpu()
        return 0 if bool(torch.isfinite(fetched[0])) else since

    def _checked_steps(self) -> Dict:
        """The first steps through the window's own step and feed; keeps their
        scene ids and losses, the first gradient as Adam got it (its first
        moment after one step over 1 - b1) and each leaf's change after
        them, as norms."""
        ids, losses = [], []
        names = {p: n for n, p in self.state.model.named_parameters()}
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        grad_norms = {}
        for k in range(CHECKED_STEPS):
            batch, m = self._step()
            ids.append(batch["scene_ids"].numpy().copy())
            losses.append(m["loss"])
            if k == 0:
                grad_norms = {names[p]: float(s["exp_avg"].norm()) / (1.0 - b1)
                              for p, s in self.state.optimizer.state.items()}
        sd = self.state.model.state_dict()
        change = {n: float((sd[n] - w).norm()) for n, w in self.weights.items()}
        return {"ids": ids, "losses": [float(x) for x in losses], "grad_norms": grad_norms,
                "change": change}

    # -- the window --------------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        steps = failed = 0
        marks = []
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with record_function("bench.step"):
                self._step()
            steps += 1
            if time.perf_counter() - t0 >= 5.0 * (len(marks) + 1):
                marks.append(steps)
            if self.state.step % self.fetch_every == 0:
                with record_function("bench.fetch"):
                    failed += self._fetch()
        self._sync()
        wall = time.perf_counter() - t0
        failed += self._fetch()
        self.extras["steps_each_5s"] = [int(x) for x in np.diff([0] + marks)]
        return {"steps": steps, "wall_s": wall, "attempted": steps, "failed": min(failed, steps),
                "metrics": {"train_points_per_s": steps * self.batch * self.npoints / wall}}

    def traced(self, prof_factory) -> Dict:
        """A further stretch of ``profile_steps`` steps under the profiler."""
        n = self.traffic["profile_steps"]
        self._sync()
        with prof_factory() as prof:
            with record_function(WINDOW_SPAN):
                for _ in range(n):
                    with record_function("bench.step"):
                        self._step()
                self._sync()
        self._fetch()
        return {"prof": prof, "steps": n}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.feed.close()
        del self.state, self.step_fn, self.scenes
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------------

    def reference_run(self, variant: str = "f32") -> Dict:
        """The reference's three steps from the same rooms, weights, scene ids
        and random streams: losses, first-gradient norms, changes.
        ``variant``: 'f32' (TF32 off), 'tf32' (the control), and two faults
        the checks are shown to catch: 'half_batch' (the loss over the first
        half of the batch) and 'altered_labels' (every labelled point's label
        moved to the next class where the chunks are cut)."""
        cfg, dev = self.cfg, self.device
        if not hasattr(self, "_ref_rooms"):
            self._ref_rooms = [ref.Room(r) for r in self.rooms]
            self._sub_len = ref.stripe_len(self._ref_rooms)
        lengths = torch.tensor([r.n for r in self._ref_rooms], dtype=torch.int64, device=dev)
        trainer = ref.Trainer(self.weights, cfg, self.batch, self.n_sched)
        visits: Dict[str, float] = {}
        losses, grad_norms = [], {}
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
            variant == "tf32")
        try:
            for k in range(CHECKED_STEPS):
                ids = self.checked["ids"][k]
                g = _stream_generator(dev, self.seed, 1000, k)
                raw = torch.randint(1 << 62, (self.batch, ref.MAX_TRIES), generator=g, device=dev)
                u = torch.rand((self.batch, self.npoints), generator=g, device=dev,
                               dtype=torch.float32)
                centres = (raw % lengths[torch.from_numpy(ids).long().to(dev)][:, None]).cpu()
                batch = ref.draw_batch(self._ref_rooms, ids, centres.numpy(), u.cpu().numpy(),
                                       self._sub_len, cfg["use_colors"], cfg["use_normals"], dev)
                if variant == "altered_labels":
                    lab = batch["labels"]
                    batch["labels"] = torch.where(lab > 0, lab % (cfg["num_classes"] - 1) + 1, lab)
                loss, grads = trainer.step(
                    batch, _stream_generator(dev, self.seed, k), visits=visits,
                    drop_rows=self.batch // 2 if variant == "half_batch" else 0)
                losses.append(loss)
                if k == 0:
                    grad_norms = {n: float(gr.norm()) for n, gr in grads.items()}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        state = trainer.state()
        change = {n: float((state[n] - w).norm()) for n, w in self.weights.items()}
        self.extras["visits"] = {k: v / CHECKED_STEPS for k, v in visits.items()}
        return {"losses": losses, "grad_norms": grad_norms, "change": change}

    def readings(self, got: Dict, want: Dict) -> Dict[str, float]:
        """The numbers of ``got`` against the reference ``want``: each step's
        relative loss gap and the largest of them; the worst leaf's gap of
        the first gradient's norm; the worst and the median leaf's gap of
        the change's norm.  Leaves whose reference gradient is under a
        thousandth of the median leaf's (biases ahead of a train-mode
        BatchNorm, whose gradient is nought but for rounding) are left out
        of the change.  ``limits/<cell>.json`` says which of them a cell
        compares."""
        steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"])]
        gref, cref = want["grad_norms"], want["change"]
        median = float(np.median(list(gref.values())))
        moved = [n for n in cref if n not in gref or gref[n] >= 1e-3 * median]
        cmed = float(np.median([cref[n] for n in moved]))
        change = {n: abs(got["change"][n] - cref[n]) / max(cref[n], cmed) for n in moved}
        grad = {n: abs(got["grad_norms"][n] - gref[n]) / max(gref[n], median) for n in gref}
        self.extras.update(left_out_of_change=sorted(set(cref) - set(moved)),
                           worst_change_leaf=max(change, key=change.get),
                           worst_grad_leaf=max(grad, key=grad.get))
        out = {f"loss_gap_step{k + 1}": v for k, v in enumerate(steps)}
        out.update(loss_gap=max(steps), grad_norm_gap=max(grad.values()),
                   change_norm_gap=max(change.values()),
                   change_norm_gap_median=float(np.median(list(change.values()))))
        return out

    def check(self, limits: Dict[str, float]) -> List[common.Check]:
        r = self.readings(self.checked, self.reference_run("f32"))
        self.extras["readings"] = r
        return [common.Check(k, r[k], limits[k]) for k in limits]
