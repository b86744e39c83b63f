"""The port's GLVis streaming (``lpfem_torch/glvis.py``) against lpfem's on
the CPU.

- ``solution_text`` of a volume and a surface field, and every rank's
  ``parallel_solution_text``, byte for byte lpfem's.
- ``GLVisStream`` against a listener on localhost: the bytes received equal
  the payloads (the single stream and one connection per rank).
- With no server listening it warns once and sends nothing, and the solver
  runs on; ``pf_run --glvis-every`` streams eta (the bytes equal
  ``solution_text`` of the final state).
"""

import socket
import threading
import warnings

import numpy as np
import pytest
import torch

from lpfem import glvis as lglvis
from lpfem.mesh import make_wave_tank_finite as lp_finite
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

from lpfem_torch import glvis
from lpfem_torch.experiments import pf_run
from lpfem_torch.mesh import make_wave_tank_finite
from lpfem_torch.space import H1Space, SurfaceSpace


def _spaces():
    ps = H1Space(make_wave_tank_finite(3, 1, 2), 2)
    ls = LH1Space(lp_finite(3, 1, 2), 2)
    return ps, ls, SurfaceSpace(ps, attr=2), LSurfaceSpace(ls, attr=2)


@pytest.mark.parametrize("kind", ["volume", "surface"])
def test_solution_text_matches_lpfem(kind):
    ps, ls, psu, lsu = _spaces()
    sp, sl = (ps, ls) if kind == "volume" else (psu, lsu)
    v = np.random.default_rng(1).standard_normal(sl.n_dofs)
    for keys in (None, "Rjlc"):
        assert glvis.solution_text(sp, torch.tensor(v), keys=keys) == \
            lglvis.solution_text(sl, v, keys=keys)


def test_parallel_solution_text_matches_lpfem():
    _, _, psu, lsu = _spaces()
    v = np.random.default_rng(2).standard_normal(lsu.n_dofs)
    for rank in range(3):
        assert glvis.parallel_solution_text(psu, v, 3, rank, keys="Rjlc") == \
            lglvis.parallel_solution_text(lsu, v, 3, rank, keys="Rjlc")


class _Listener:
    """A localhost server that accepts ``n`` connections and keeps what each
    one sends until it closes."""

    def __init__(self, n: int = 1):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.data = [b""] * n
        self.thread = threading.Thread(target=self._serve, args=(n,),
                                       daemon=True)
        self.thread.start()

    def _serve(self, n):
        conns = [self.sock.accept()[0] for _ in range(n)]
        for i, c in enumerate(conns):
            with c:
                while chunk := c.recv(1 << 16):
                    self.data[i] += chunk

    def join(self):
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.sock.close()


def test_stream_to_a_listener():
    _, _, psu, _ = _spaces()
    v = torch.tensor(np.random.default_rng(3).standard_normal(psu.n_dofs))
    srv = _Listener()
    vis = glvis.GLVisStream("127.0.0.1", srv.port)
    assert vis.send(psu, v, keys="Rjlc") and vis.send(psu, 2 * v)
    vis.close()
    srv.join()
    assert srv.data[0] == (glvis.solution_text(psu, v, keys="Rjlc")
                           + glvis.solution_text(psu, 2 * v)).encode()

    srv = _Listener(2)
    vis = glvis.GLVisStream("127.0.0.1", srv.port)
    assert vis.send_parallel(psu, v, 2, keys="Rjlc")
    vis.close()
    srv.join()
    assert srv.data == [glvis.parallel_solution_text(psu, v, 2, r,
                                                     keys="Rjlc").encode()
                        for r in range(2)]


def _free_port() -> int:
    with socket.create_server(("127.0.0.1", 0)) as s:
        return s.getsockname()[1]


def test_stream_warns_once_without_a_server():
    _, _, psu, _ = _spaces()
    v = np.zeros(psu.n_dofs)
    vis = glvis.GLVisStream("127.0.0.1", _free_port(), timeout=1.0)
    with pytest.warns(RuntimeWarning, match="unable to connect"):
        assert not vis.send(psu, v)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not vis.send(psu, v)
        assert not vis.send_parallel(psu, v, 2)


def test_pf_run_streams_eta(tmp_path):
    srv = _Listener()
    t, y, phi = pf_run.main([
        "--preset", "pf_linear_periodic", "--order", "2", "--nsteps", "2",
        "--device", "cpu", "--checkpoint-every", "2", "--glvis-every", "2",
        "--glvis-host", "127.0.0.1", "--glvis-port", str(srv.port)])
    srv.join()
    from lpfem_torch.configs import preset
    from lpfem_torch.problem import Problem
    prob = Problem(preset("pf_linear_periodic", order=2, nsteps=2), "cpu")
    ns = prob.surf.n_dofs
    assert srv.data[0] == glvis.solution_text(prob.surf, y[:ns],
                                              keys="Rjlc").encode()
