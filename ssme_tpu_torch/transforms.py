"""Constrained <-> unconstrained parameter transforms with log-Jacobians.

PyTorch counterpart of ``ssme_tpu/transforms.py``: each parameter carries
a static integer transform code, and each column of a parameter tensor
goes through its own bijection (JAX evaluates all four everywhere and
selects with masks; here the static codes pick on the host).

====================  =======================  =====================  ==========================
name                  trans  z = f(p)          inverse p = f^-1(z)    log|d p / d z|(z)
====================  =======================  =====================  ==========================
``null``              z = p                    p = z                  0
``log`` (0, inf)      z = log p                p = e^z                z
``logit`` (0, 1)      z = log(p/(1-p))         p = sigmoid(z)         -z - 2 log(1 + e^-z)
``twice_fisher``      z = log((1+p)/(1-p))     p = tanh(z/2)          log 2 + z - 2 log(1 + e^z)
(-1, 1)
====================  =======================  =====================  ==========================
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

TT_NULL = 0
TT_LOG = 1
TT_LOGIT = 2
TT_TWICE_FISHER = 3

_NAME_TO_CODE = {
    "null": TT_NULL,
    "log": TT_LOG,
    "logit": TT_LOGIT,
    "twice_fisher": TT_TWICE_FISHER,
}


def codes_from_names(names: Sequence[str]) -> np.ndarray:
    """Map transform names to an int32 code vector; unknown names raise."""
    try:
        return np.asarray([_NAME_TO_CODE[n] for n in names], dtype=np.int32)
    except KeyError as e:
        raise ValueError(
            f"that transform type was not accounted for: {e.args[0]!r}; "
            f"valid: {sorted(_NAME_TO_CODE)}") from None


def _per_column(z, codes, fns):
    """Apply ``fns[code]`` to each column of the last axis.  The codes are
    static, so the choice happens on the host and nothing is copied to
    the device."""
    codes = np.broadcast_to(np.asarray(codes), z.shape[-1:])
    return torch.stack([fns[int(c)](z[..., k]) for k, c in enumerate(codes)],
                       dim=-1)


def unconstrain(params, codes) -> torch.Tensor:
    """Constrained -> unconstrained.  Out-of-domain inputs give nan/inf."""
    return _per_column(torch.as_tensor(params), codes, {
        TT_NULL: lambda p: p,
        TT_LOG: torch.log,
        TT_LOGIT: lambda p: torch.log(p) - torch.log1p(-p),
        TT_TWICE_FISHER: lambda p: torch.log1p(p) - torch.log1p(-p),
    })


def constrain(trans_params, codes) -> torch.Tensor:
    """Unconstrained -> constrained; twice_fisher as tanh(z/2)."""
    return _per_column(torch.as_tensor(trans_params), codes, {
        TT_NULL: lambda z: z,
        TT_LOG: torch.exp,
        TT_LOGIT: torch.sigmoid,
        TT_TWICE_FISHER: lambda z: torch.tanh(0.5 * z),
    })


def log_det_jacobian(trans_params, codes) -> torch.Tensor:
    """Summed log|d constrained / d unconstrained| at the transformed
    value (softplus forms for float32 stability)."""
    return _per_column(torch.as_tensor(trans_params), codes, {
        TT_NULL: torch.zeros_like,
        TT_LOG: lambda z: z,
        TT_LOGIT: lambda z: -z - 2.0 * F.softplus(-z),
        TT_TWICE_FISHER: lambda z: math.log(2.0) + z - 2.0 * F.softplus(z),
    }).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class ParamTransform:
    """Static description of a parameter vector's per-element bijections."""

    names: Tuple[str, ...]

    def __init__(self, names: Union[Sequence[str], "ParamTransform"]):
        if isinstance(names, ParamTransform):
            names = names.names
        names = tuple(names)
        codes_from_names(names)  # validate eagerly
        object.__setattr__(self, "names", names)

    @property
    def dim(self) -> int:
        return len(self.names)

    @property
    def codes(self) -> np.ndarray:
        return codes_from_names(self.names)

    def constrain(self, trans_params) -> torch.Tensor:
        return constrain(trans_params, self.codes)

    def unconstrain(self, params) -> torch.Tensor:
        return unconstrain(params, self.codes)

    def log_det_jacobian(self, trans_params) -> torch.Tensor:
        return log_det_jacobian(trans_params, self.codes)


class ParamPack:
    """Eager container mirroring the reference ``param::pack``.

    Stores the parameter vector in the transformed (unconstrained) space
    (``parameters.h:159``) beside its :class:`ParamTransform`: host-side
    sugar for scripts and tests, on the device of the values it is given.
    """

    def __init__(self, params, transform: Union[ParamTransform,
                                                Sequence[str]],
                 from_transformed: bool = True):
        # pack(params, transform_names, from_transformed)
        # (parameters.h:463-485)
        self.transform = ParamTransform(transform)
        params = torch.as_tensor(params)
        if params.shape[-1] != self.transform.dim:
            raise ValueError("params needs to be the right size (full)")
        self._trans = (params if from_transformed
                       else self.transform.unconstrain(params))
        self._capacity = self.transform.dim

    @classmethod
    def empty(cls, numelem: int) -> "ParamPack":
        """An empty pack of fixed capacity for incremental construction,
        the reference's default-constructed ``pack<float_t, numelem>()``
        (``parameters.h:503-507``), filled by
        :meth:`add_param_and_transform`."""
        if numelem < 1:
            raise ValueError("numelem must be >= 1")
        self = cls.__new__(cls)
        self.transform = None
        self._trans = torch.zeros((0,))
        self._capacity = int(numelem)
        return self

    def add_param_and_transform(self, elem, transform_name: str,
                                is_transformed: bool = True) -> "ParamPack":
        """Append one (value, transform) element, reference semantics
        (``parameters.h:511-537``): the value is stored in the transformed
        space, converted first when ``is_transformed=False``; adding past
        the declared capacity raises (``std::length_error``,
        ``parameters.h:521,536``).  Returns ``self`` for chaining."""
        filled = 0 if self.transform is None else self.transform.dim
        if filled >= self._capacity:
            raise ValueError("can't add any more transformations")
        names = () if self.transform is None else self.transform.names
        new_tf = ParamTransform(names + (transform_name,))
        elem = torch.as_tensor(elem, dtype=torch.get_default_dtype(),
                               device=self._trans.device if filled else None)
        elem = elem.reshape(1)
        if not is_transformed:
            elem = unconstrain(elem, codes_from_names((transform_name,)))
        self.transform = new_tf
        self._trans = torch.cat([self._trans.reshape(-1).to(elem), elem])
        return self

    def _require_full(self):
        filled = 0 if self.transform is None else self.transform.dim
        if filled != self._capacity:
            raise ValueError(
                f"pack is not fully constructed: {filled} of "
                f"{self._capacity} elements added")

    @property
    def dim(self) -> int:
        return self._capacity

    def get_trans_params(self, start: int = None,
                         end: int = None) -> torch.Tensor:
        # subset semantics of parameters.h:598-602 (inclusive end)
        self._require_full()
        if start is None:
            return self._trans
        end = start if end is None else end
        return self._trans[..., start:end + 1]

    def get_untrans_params(self, start: int = None,
                           end: int = None) -> torch.Tensor:
        # parameters.h:587-618 (inclusive end)
        self._require_full()
        p = self.transform.constrain(self._trans)
        if start is None:
            return p
        end = start if end is None else end
        return p[..., start:end + 1]

    def get_log_jacobian(self) -> torch.Tensor:
        self._require_full()
        return self.transform.log_det_jacobian(self._trans)


__all__ = [
    "TT_NULL", "TT_LOG", "TT_LOGIT", "TT_TWICE_FISHER",
    "codes_from_names", "constrain", "unconstrain", "log_det_jacobian",
    "ParamTransform", "ParamPack",
]
