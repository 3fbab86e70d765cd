"""The LM substrate of the port: the registry architectures' blocks and the
:class:`~repro_torch.models.transformer.Model` facade (the port of the JAX
package's ``models/``)."""
from .transformer import Model, params_from_numpy, params_to_numpy

__all__ = ["Model", "params_from_numpy", "params_to_numpy"]
