"""Introspective XML-RPC control plane.

Equivalent of python/introspective_xmlrpc_server.py (+ the
grc/baz_xmlrpc_server.xml role): expose a running flowgraph's
retunable parameters over XML-RPC so external tools can call
``set_<block>_<param>(value)`` / ``get_<block>_<param>()`` — the remote
variable-control plane. Here the introspection target is the executor's
``params`` dict: every numeric leaf is automatically exported.

The port's copy of ``grbaz_tpu/net/control_server.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict
from xmlrpc.server import SimpleXMLRPCServer

import numpy as np


class ControlServer:
    """XML-RPC server over an executor-style params dict.

    ``holder`` is any object with a ``params`` attribute (dict of
    per-block param dicts) — e.g. StreamExecutor. Setters replace the
    leaf with the same dtype, so retunes stay recompile-free.
    """

    def __init__(self, holder, address=("127.0.0.1", 0)):
        self.holder = holder
        self.server = SimpleXMLRPCServer(address, allow_none=True,
                                         logRequests=False)
        self.server.register_function(self.list_params, "list_params")
        self.server.register_function(self.get_param, "get_param")
        self.server.register_function(self.set_param, "set_param")
        self.server.register_introspection_functions()
        # register set_<block>_<param> style callables (the reference's
        # introspective surface)
        for block, pdict in (holder.params or {}).items():
            if not isinstance(pdict, dict):
                continue
            for key in pdict:
                name = f"{block}.{key}"
                self.server.register_function(
                    self._make_setter(block, key), f"set_{block}_{key}")
                self.server.register_function(
                    self._make_getter(block, key), f"get_{block}_{key}")
        self._thr = threading.Thread(target=self.server.serve_forever,
                                     daemon=True)
        self._thr.start()

    @property
    def port(self):
        return self.server.server_address[1]

    def _make_setter(self, block, key):
        def setter(value):
            return self.set_param(block, key, value)
        return setter

    def _make_getter(self, block, key):
        def getter():
            return self.get_param(block, key)
        return getter

    def list_params(self) -> Dict[str, list]:
        out = {}
        for block, pdict in (self.holder.params or {}).items():
            if isinstance(pdict, dict):
                out[block] = sorted(pdict.keys())
        return out

    def get_param(self, block: str, key: str):
        v = self.holder.params[block][key]
        if hasattr(v, "detach"):  # a tensor of the port, any device
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        return a.item() if a.ndim == 0 else a.tolist()

    def set_param(self, block: str, key: str, value) -> bool:
        leaf = self.holder.params[block][key]
        if hasattr(leaf, "detach"):
            # a tensor leaf stays a tensor of its dtype on its device
            new = leaf.new_tensor(value).reshape(leaf.shape)
        else:
            old = np.asarray(leaf)
            new = np.asarray(value, dtype=old.dtype).reshape(old.shape)
        # params dicts may be shared; replace the leaf in place
        self.holder.params[block] = dict(self.holder.params[block],
                                         **{key: new})
        return True

    def close(self):
        self.server.shutdown()
        self.server.server_close()
