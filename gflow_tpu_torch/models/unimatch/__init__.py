from .gmflow import GMFlow, GMFlowConfig, forward_backward_consistency
