"""Core of the port: the layer-wise parallelism strategy search (the
paper's contribution; copies of ``repro.core``'s search modules, with an
H100 chip model beside the reference's) and the time scan.

Public API:

    from repro_torch.core import (
        MeshSpec, h100_mesh_spec, single_pod_mesh_spec, multi_pod_mesh_spec,
        LayerConfig, enumerate_configs,
        CompGraph, LayerNode, Edge, TensorSpec, Strategy,
        CostModel,
        find_strategy, find_strategy_brute_force, SearchOptions,
        data_parallel, model_parallel, owt,
    )

The reference's sharding helpers (``constrain``, ``current_mesh``,
``pspec``, ``sharding``, ``use_mesh``) come with the realization slice.
"""

from .config import DATA_DIMS, PARAM_DIMS, LayerConfig, enumerate_configs
from .cost_model import CostModel
from .device import (
    GiB,
    H100_SXM,
    IB_BW,
    ICI_BW,
    NVLINK_BW,
    POD_BW,
    TPU_V5E,
    AxisSpec,
    ChipSpec,
    CollectiveCost,
    MeshSpec,
    h100_mesh_spec,
    multi_pod_mesh_spec,
    single_pod_mesh_spec,
)
from .elimination import GraphOptimizer, brute_force_optimize
from .graph import CompGraph, Edge, LayerNode, Strategy, TensorSpec, uniform_strategy
from .scan import remat_time_scan
from .search import SearchOptions, config_space, find_strategy, find_strategy_brute_force
from .strategies import BASELINES, data_parallel, model_parallel, owt

__all__ = [
    "AxisSpec", "BASELINES", "ChipSpec", "CollectiveCost", "CompGraph",
    "CostModel", "DATA_DIMS", "Edge", "GiB", "GraphOptimizer", "H100_SXM",
    "IB_BW", "ICI_BW", "LayerConfig", "LayerNode", "MeshSpec", "NVLINK_BW",
    "PARAM_DIMS", "POD_BW", "SearchOptions", "Strategy", "TensorSpec",
    "TPU_V5E", "brute_force_optimize", "config_space", "data_parallel",
    "enumerate_configs", "find_strategy", "find_strategy_brute_force",
    "h100_mesh_spec", "model_parallel", "multi_pod_mesh_spec", "owt",
    "remat_time_scan", "single_pod_mesh_spec", "uniform_strategy",
]
