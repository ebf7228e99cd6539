"""TFLite graph (npz) -> PyTorch module lowering."""

from .lowering import (Graph, TFLiteNet, build_torch_fn, graph_flops,
                       load_model_fn, params_from_consts)

__all__ = ["Graph", "TFLiteNet", "build_torch_fn", "graph_flops",
           "load_model_fn", "params_from_consts"]
