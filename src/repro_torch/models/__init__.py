"""The model zoo in PyTorch (dense, MoE, vision, audio and the SSM families),
over dicts of stacked parameter tensors."""
from repro_torch.models.defs import ParamDef, init_numpy, init_params, param_count  # noqa: F401
from repro_torch.models.model import Model, build_model, params_from_numpy  # noqa: F401
