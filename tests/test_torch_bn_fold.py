"""BN folding of the port (``train/bn_fold.py``) against the JAX package's.

The same flat weights, with seeded non-trivial BN statistics and affines
(``test_torch_model._flat_variables``), go into a JAX train state and a port
model; both are folded.  Limits, and why:

- folded parameters: within 1e-6 relative (``rsqrt`` and the products
  round alike; a few ulps at most);
- ``n_folded``: equal (every ``PointConv`` with a BN, ``fc1`` included);
- folded against unfolded logits: JAX's own limits (atol 5e-4, rtol 1e-3,
  argmax agreement >= 99.9 %): the same math reassociated;
- a folded port model exported through the bridge (neutral BN entries)
  and applied by JAX: within 1e-4 of JAX's folded logits, the limit of the
  bridged model tests (``tests/test_torch_model.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.train import create_state
from pointcloud_segmentation_attention_tpu.train.bn_fold import (
    fold_batchnorm_for_inference as jfold,
)
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten
from pointcloud_segmentation_attention_tpu.train.steps import seg_predict_step as jpredict
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.eval import ResidentSceneServer
from pointcloud_segmentation_attention_tpu_torch.nn import Dense, PointConv
from pointcloud_segmentation_attention_tpu_torch.train import (
    export_jax_variables,
    load_jax_variables,
    seg_predict_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.bn_fold import (
    FoldedBatchNorm,
    fold_batchnorm_for_inference,
)
from test_torch_model import TINY, _flat_variables, _inputs, _unflatten

MODELS = {"sem_seg_features": True, "sem_seg_attention_and_pooling": False}  # name: features


def _flat_of(tree) -> dict:
    flat = {f"params/{k}": np.asarray(v) for k, v in _flatten(tree.params).items()}
    flat.update({f"batch_stats/{k}": np.asarray(v)
                 for k, v in _flatten(tree.batch_stats).items()})
    return flat


@pytest.fixture(scope="module", params=list(MODELS))
def bridged(request):
    """(name, JAX state, port model, points, features) from one set of flat
    weights with non-trivial BN."""
    name = request.param
    pts, feats = _inputs(2, 128, seed=4)
    feats = feats if MODELS[name] else None
    jm = jmodels.get_model(name, num_classes=21, **TINY)
    state = create_state(jm, optax.adam(1e-3), jax.random.PRNGKey(0), jnp.asarray(pts[:1]),
                         None if feats is None else jnp.asarray(feats[:1]), train=False)
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 7)
    tree = _unflatten(flat)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    tm = tmodels.get_model(name, device="cpu", **TINY)
    load_jax_variables(flat, tm)
    return name, state, tm, pts, feats


def _port_logits(model, pts, feats):
    return seg_predict_step(model, torch.from_numpy(pts),
                            None if feats is None else torch.from_numpy(feats)).numpy()


def _jax_logits(state, pts, feats):
    return np.asarray(jpredict(state, jnp.asarray(pts),
                               None if feats is None else jnp.asarray(feats)))


def test_folded_parameters_and_count_match_jax(bridged):
    _, state, tm, _, _ = bridged
    jfolded, jn = jfold(state)
    folded, n = fold_batchnorm_for_inference(tm)
    assert n == jn and n >= 10
    want = _flat_of(jfolded)
    got = export_jax_variables(folded)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    convs = [m for m in folded.modules() if isinstance(m, PointConv)]
    assert sum(isinstance(c.bn, FoldedBatchNorm) for c in convs) == n
    # The input model is left as it was.
    assert not any(isinstance(m, FoldedBatchNorm) for m in tm.modules())


def test_folded_logits_within_jax_limits(bridged):
    _, state, tm, pts, feats = bridged
    want = _port_logits(tm, pts, feats)
    folded, _ = fold_batchnorm_for_inference(tm)
    got = _port_logits(folded, pts, feats)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


def test_folded_export_loads_into_jax(bridged):
    name, state, tm, pts, feats = bridged
    jfolded, _ = jfold(state)
    folded, _ = fold_batchnorm_for_inference(tm)
    tree = _unflatten(export_jax_variables(folded))
    carried = jfolded.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    np.testing.assert_allclose(_jax_logits(carried, pts, feats),
                               _jax_logits(jfolded, pts, feats), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_port_logits(folded, pts, feats),
                               _jax_logits(jfolded, pts, feats), rtol=1e-4, atol=1e-4)


def test_attention_bn_is_left_alone(bridged):
    name, _, tm, _, _ = bridged
    folded, _ = fold_batchnorm_for_inference(tm)
    standalone = [(k, m) for k, m in folded.named_modules() if k.endswith("attention_bn")]
    if name != "sem_seg_attention_and_pooling":
        assert not standalone
        return
    assert len(standalone) == 4
    before = dict(tm.named_modules())
    for k, m in standalone:
        for a, b in zip(m.state_dict().values(), before[k].state_dict().values()):
            assert torch.equal(a, b), k


def test_nothing_to_fold_raises(bridged):
    _, _, tm, _, _ = bridged
    folded, _ = fold_batchnorm_for_inference(tm)
    with pytest.raises(ValueError, match="no foldable"):
        fold_batchnorm_for_inference(folded)
    with pytest.raises(ValueError, match="no foldable"):
        fold_batchnorm_for_inference(torch.nn.Sequential(Dense(3, 4), PointConv(4, 4, bn=False)))


def test_folded_model_serves_through_resident_path():
    """JAX's ``test_folded_state_serves_through_resident_path`` on the port."""
    tm = tmodels.seeded_model("sem_seg_features", seed=2, device="cpu", **TINY)
    folded, _ = fold_batchnorm_for_inference(tm)
    rng = np.random.RandomState(3)
    scene = {"points": (rng.rand(2000, 3) * [5.0, 4.0, 2.5]).astype(np.float32),
             "colors": rng.randint(0, 256, (2000, 3)).astype(np.uint8),
             "normals": rng.rand(2000, 3).astype(np.float32)}
    kw = dict(batch_size=4, layout="f32", pad_multiple=2048, device="cpu")
    base = ResidentSceneServer(tm, 128, **kw).predict_scene(scene)
    fold = ResidentSceneServer(folded, 128, **kw).predict_scene(scene)
    assert (base == fold).mean() > 0.999
