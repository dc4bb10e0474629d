from perphil_tpu_torch.forms.spaces import (
    Function,
    FunctionSpace,
    IndexedFunctionSpace,
    MixedFunctionSpace,
    create_function_spaces,
    mixed_space,
)

__all__ = [
    "Function",
    "FunctionSpace",
    "IndexedFunctionSpace",
    "MixedFunctionSpace",
    "create_function_spaces",
    "mixed_space",
]
