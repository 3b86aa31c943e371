"""Remote process launcher (grc/baz_run_remote.xml equivalent).

The reference's ``run_remote`` GRC variable launches a command on
another machine over SSH (optionally with X forwarding) when the
flowgraph starts. Same capability as a class: build the ssh command
line, spawn it, and tear it down with the owning object.

The port's copy of ``grbaz_tpu/utils/run_remote.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import shlex
import subprocess
from typing import List, Optional


class RunRemote:
    def __init__(self, host: str, command: str, user: str = "",
                 port: int = 22, forward_x: bool = False,
                 ssh_args: str = "", auto_start: bool = True,
                 spawn=subprocess.Popen):
        self.host = host
        self.command = command
        self.user = user
        self.port = int(port)
        self.forward_x = bool(forward_x)
        self.ssh_args = ssh_args
        self._spawn = spawn
        self._p: Optional[subprocess.Popen] = None
        if auto_start:
            self.start()

    def argv(self) -> List[str]:
        args = ["ssh", "-p", str(self.port)]
        if self.forward_x:
            args.append("-X")
        if self.ssh_args:
            args += shlex.split(self.ssh_args)
        target = f"{self.user}@{self.host}" if self.user else self.host
        args += [target, self.command]
        return args

    def start(self):
        if self._p is None:
            self._p = self._spawn(self.argv())
        return self._p

    def poll(self):
        return self._p.poll() if self._p else None

    def stop(self):
        if self._p is not None:
            self._p.terminate()
            try:
                self._p.wait(timeout=5)
            except Exception:
                self._p.kill()
            self._p = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
