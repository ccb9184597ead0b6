"""The single-copy register: the host model and its device form.

The port's copy of ``examples/single_copy_register.py`` (the model:
``SingleCopyModelCfg.into_model()``, whose server is ``SingleCopyActor``)
and of ``stateright_tpu/tpu/models/single_copy.py`` (the device
encoding), after the reference's ``examples/single-copy-register.rs``:
``server_count`` servers, each one value cell (a Put overwrites it and
acks, a Get replies with it), and ``client_count`` clients that each Put
one value and then Get, with a linearizability tester riding along as
history, checked for "linearizable" (always) and "value chosen"
(sometimes). Unreplicated, so not linearizable with more than one
server. Gates: 93 unique at 2 clients / 1 server (47 with symmetry),
4,243 / 6,778 states at 3 and 400,233 / 731,789 at 4; the
"linearizable" counterexample at 2 clients / 2 servers.

The device form is the register workload's (``register_workload.py``)
with one lane a server, the stored value's index (0 = NO_VALUE, else 1 +
the writer's client index), and no internal messages. At 1 server every
client shares residue class 0, so the client-permutation group is the
whole symmetric group. Its CUDA device code (``cuda_model()``) is
``csrc/models/single_copy.cuh`` on ``csrc/models/register_workload.cuh``,
which the single-kernel wave and the sender kernel run on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..actor import NO_VALUE
from ..actor_device import EMPTY_ENV
from ..model import Model, Property
from ..register_workload import (GET, GETOK, PUT, PUTOK,
                                 RegisterWorkloadDevice, cuda_instance,
                                 register_init_state)

__all__ = ["SingleCopySys", "SingleCopyDevice"]


class SingleCopySys(Model):
    """``client_count`` (1 to 4) Put-then-Get clients of ``server_count``
    single-copy servers: ``SingleCopyModelCfg(client_count,
    server_count).into_model()``."""

    #: the JAX package's model is an ``ActorModel``: the same name lets
    #: each package resume the other's checkpoints
    checkpoint_name = "ActorModel"

    def __init__(self, client_count: int, server_count: int = 1):
        self.client_count = client_count
        self.server_count = server_count

    def device_model(self) -> "SingleCopyDevice":
        return SingleCopyDevice(self.client_count, self.server_count)

    def init_states(self):
        """``SingleCopyActor.on_start``: every server holds NO_VALUE."""
        return [register_init_state([NO_VALUE] * self.server_count,
                                    self.client_count)]

    def properties(self):
        return [Property.always("linearizable"),
                Property.sometimes("value chosen")]


class SingleCopyDevice(RegisterWorkloadDevice):
    SERVER_LANES = ("value",)
    max_out = 1

    #: (clients, servers) that ``csrc/wave_single_copy.cu`` instantiates
    CUDA_INSTANCES = ((2, 1), (3, 1), (4, 1), (2, 2))

    def cuda_model(self):
        """``csrc/models/single_copy.cuh`` at this client and server count
        and ``net_slots`` (the entry point refuses more slots than the
        default's). Raises for counts it holds no instance of."""
        cuda_instance("single_copy", self.C, self.S, self.CUDA_INSTANCES)
        return "single_copy", (self.C, self.S, self.net_slots)

    def server_lane_bits(self) -> tuple:
        return (max(1, self.C.bit_length()),)  # the value index, 0..C

    # -- Client symmetry: a server's only client-derived datum is the
    # stored value index; with no internal kinds the generic envelope
    # rewrite covers the rest.

    def sym_rewrite_servers(self, servers, t):
        return t["val"][servers.clamp(max=self.value_mask)]

    def server_deliver(self, lanes, f):
        """``SingleCopyActor.on_msg`` at each row's ``f.dst`` server: a Put
        stores its value and acks, a Get replies with the cell."""
        value = lanes[:, 0]
        put_case, get_case = f.kind == PUT, f.kind == GET
        putok = self.build_env(dst=f.src, src=f.dst, kind=PUTOK, req=f.req)
        getok = self.build_env(dst=f.src, src=f.dst, kind=GETOK, req=f.req,
                               value=value)
        reply = torch.where(put_case, putok,
                            torch.where(get_case, getok, EMPTY_ENV))
        return (torch.where(put_case, f.value, value)[:, None],
                put_case | get_case, reply[:, None])

    # -- Host codec: a server's state is the bare value ----------------------

    def encode_server(self, server_state, vec: np.ndarray,
                      base: int) -> None:
        vec[base] = self.value_idx(server_state)

    def decode_server(self, vec: np.ndarray, base: int, server_index: int):
        return self.value_of(int(vec[base]))
