"""Driver of a closed loop of sampler training steps of the Point
Transformer: ``train_sampler``'s loop, feed, window and checks, with the
Point Transformer's plain reference (``reference/point_transformer.py``)
in the comparison and two readings kept from the traced stretch.

``traced`` keeps, before ``run.py`` drops the profile, the device seconds
of the kNN kernel (``csrc/knn.cu``, found by its name) and those of the
kernels launched under the program's span ``nn.vector_attention`` (the
attention layers' forward; ``lib/span_kernels.py``), read by
``metrics/knn_roofline.train.py`` and
``metrics/vector_attention_fwd_ms.train.py``.
"""
from __future__ import annotations

from typing import Dict

import torch

from port_bench.drivers import train_sampler
from port_bench.drivers.train_sampler import CHECKED_STEPS, _stream_generator
from port_bench.lib import span_kernels
from port_bench.reference import point_transformer as ref_pt
from port_bench.reference import train as ref

KNN_KERNEL = "knn_kernel"
ATTENTION_SPAN = "nn.vector_attention"


class Driver(train_sampler.Driver):

    def traced(self, prof_factory) -> Dict:
        out = super().traced(prof_factory)
        prof = out["prof"]
        out["knn_kernel_s"] = span_kernels.seconds_named(prof, KNN_KERNEL)
        out["vector_attention_fwd_s"] = span_kernels.seconds_by_span(prof).get(
            ATTENTION_SPAN, 0.0)
        return out

    def reference_run(self, variant: str = "f32") -> Dict:
        """``train_sampler.Driver.reference_run`` with the Point Transformer's
        reference trainer: the same rooms, weights, scene ids and random
        streams, and the same variants ('f32', 'tf32', 'half_batch',
        'altered_labels')."""
        cfg, dev = self.cfg, self.device
        if not hasattr(self, "_ref_rooms"):
            self._ref_rooms = [ref.Room(r) for r in self.rooms]
            self._sub_len = ref.stripe_len(self._ref_rooms)
        lengths = torch.tensor([r.n for r in self._ref_rooms], dtype=torch.int64, device=dev)
        trainer = ref_pt.Trainer(self.weights, cfg, self.batch, self.n_sched)
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
                    batch, _stream_generator(dev, self.seed, k),
                    drop_rows=self.batch // 2 if variant == "half_batch" else 0)
                losses.append(loss)
                if k == 0:
                    grad_norms = {n: float(gr.norm()) for n, gr in grads.items()}
                del batch, grads
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        state = trainer.state()
        change = {n: float((state[n] - w).norm()) for n, w in self.weights.items()}
        return {"losses": losses, "grad_norms": grad_norms, "change": change}
