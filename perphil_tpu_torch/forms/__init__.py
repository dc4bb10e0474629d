from perphil_tpu_torch.forms.spaces import (
    Function,
    FunctionSpace,
    IndexedFunctionSpace,
    MixedFunctionSpace,
    create_function_spaces,
    mixed_space,
)
from perphil_tpu_torch.forms.dpp import (
    DPPResidualForm,
    FieldBilinearForm,
    FieldLinearForm,
    dpp_delayed_form,
    dpp_form,
    dpp_splitted_form,
)

__all__ = [
    "Function",
    "FunctionSpace",
    "IndexedFunctionSpace",
    "MixedFunctionSpace",
    "create_function_spaces",
    "mixed_space",
    "DPPResidualForm",
    "FieldBilinearForm",
    "FieldLinearForm",
    "dpp_form",
    "dpp_delayed_form",
    "dpp_splitted_form",
]
