"""End-to-end recipes of the port, copies of the JAX package's sem_seg
recipes, each a ``run_*`` function and a ``main`` with ``--device``:
zero-precompute training, synthetic convergence, the Table 1 attention and
Table 3 feature ablations, the Table 4 context margin, the matched-cost
diversity comparison and the attention wire parity."""
from pointcloud_segmentation_attention_tpu_torch.recipes.attention_ablation import (
    run_attention_ablation,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.attention_wire_parity import (
    run_attention_wire_parity,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.context_margin import (
    run_context_margin,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.diversity_matched import (
    run_diversity_matched,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.feature_ablation import (
    run_feature_ablation,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.synthetic_convergence import (
    run_synthetic_convergence,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.zero_precompute import (
    run_zero_precompute,
)

__all__ = ["run_attention_ablation", "run_attention_wire_parity", "run_context_margin",
           "run_diversity_matched", "run_feature_ablation", "run_synthetic_convergence",
           "run_zero_precompute"]
