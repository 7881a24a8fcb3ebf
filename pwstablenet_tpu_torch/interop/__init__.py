"""Weights from elsewhere into the port, and back: the JAX package's
parameter trees (``from_jax``) and Orbax checkpoints (``from_orbax``),
and the reference's PyTorch ``.pth`` layout (``torch_import``, with
``torch_ref`` the layout's modules)."""

from pwstablenet_tpu_torch.interop.from_jax import (  # noqa: F401
    jax_params_to_state_dict,
    state_dict_to_jax_params,
    state_dict_to_tree,
    tree_to_state_dict,
)
from pwstablenet_tpu_torch.interop.torch_import import (  # noqa: F401
    feat_state_dict_to_port,
    load_torch_checkpoint,
    port_to_torch_state_dict,
    torch_state_dict_to_port,
    torchvision_vgg_to_port,
)
