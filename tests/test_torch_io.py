"""Port parity: the wire formats (``io/polytraj.py``).

Every case of tests/test_io.py runs on the port. The same MINCO
trajectories go through both packages' encoders: the ``PolyTraj`` JSON
each writes is the other's string byte for byte, each side decodes the
other's message to the same float32 coefficients, and a ``MincoTraj``
dict round-trips both ways. Decoding a ``MincoTraj`` re-solves MINCO in
float32 on each side: positions within 1e-4 of the source trajectory (the
JAX test's limit) and within 1e-5 of JAX's decode.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu import io as jio
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.utils import trajectory as jtrj
from svsdf_tpu_torch.io import (MincoTraj, PolyTraj, PositionCommand,
                                decode_minco_traj, decode_poly_traj,
                                encode_minco_traj, encode_poly_traj)
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)


def _params(n=4, seed=0):
    rng = np.random.default_rng(seed)
    head = np.zeros((3, 3), np.float32)
    tail = np.zeros((3, 3), np.float32)
    tail[0] = [8.0, 1.0, 0.5]
    wps = rng.normal(0, 1, (n - 1, 3)).astype(np.float32)
    wps[:, 0] = np.linspace(2, 6, n - 1)
    times = np.full((n,), 1.2, np.float32)
    return times, head, tail, wps


def _traj(n=4, seed=0):
    """(JAX trajectory, the same as a port batch of one), float32."""
    jt = jminco.solve(*map(jnp.asarray, _params(n, seed)))
    return jt, trj.Trajectory(torch.tensor(np.asarray(jt.coeffs))[None],
                              torch.tensor(np.asarray(jt.durations))[None])


def _eval(t, ts, order=0):
    return trj.eval_at(t, torch.as_tensor(ts, dtype=t.coeffs.dtype)[None],
                       order)[0].numpy()


def test_polytraj_roundtrip():
    jt, traj = _traj()
    msg = encode_poly_traj(traj, drone_id=3, traj_id=7, start_time=1.5)
    assert msg.order == 5
    assert len(msg.coef_x) == traj.num_pieces * 6
    back = decode_poly_traj(msg, device="cpu")
    assert back.coeffs.dtype == torch.float32
    torch.testing.assert_close(back.coeffs, traj.coeffs, rtol=0, atol=0)
    ts = np.linspace(0, float(traj.total_duration[0]), 50)
    for order in (0, 1, 2, 3):
        np.testing.assert_allclose(_eval(back, ts, order),
                                   _eval(traj, ts, order), rtol=1e-4,
                                   atol=1e-4)


def test_polytraj_json_is_jaxs_both_ways():
    jt, traj = _traj(seed=1)
    msg = encode_poly_traj(traj)
    jmsg = jio.encode_poly_traj(jt)
    assert msg.to_json() == jmsg.to_json()
    msg2 = PolyTraj.from_json(jmsg.to_json())
    np.testing.assert_array_equal(msg.coef_x, msg2.coef_x)
    np.testing.assert_array_equal(msg.duration, msg2.duration)
    back = decode_poly_traj(msg2, device="cpu")
    np.testing.assert_array_equal(back.durations[0].numpy(),
                                  np.asarray(traj.durations[0]))
    jback = jio.decode_poly_traj(jio.PolyTraj.from_json(msg.to_json()))
    np.testing.assert_array_equal(back.coeffs[0].numpy(),
                                  np.asarray(jback.coeffs))


def test_polytraj_encodes_a_batch_of_one():
    _, traj = _traj()
    two = trj.Trajectory(traj.coeffs.repeat(2, 1, 1, 1),
                         traj.durations.repeat(2, 1))
    with pytest.raises(ValueError):
        encode_poly_traj(two)
    flat = trj.Trajectory(traj.coeffs[..., :2], traj.durations)
    msg = encode_poly_traj(flat)
    assert not msg.coef_z.any()
    assert msg.to_json() == jio.encode_poly_traj(jtrj.Trajectory(
        jnp.asarray(flat.coeffs[0].numpy()),
        jnp.asarray(flat.durations[0].numpy()))).to_json()


def test_polytraj_rejects_bad_order():
    _, traj = _traj()
    msg = encode_poly_traj(traj)._replace(order=4)
    with pytest.raises(ValueError):
        decode_poly_traj(msg, device="cpu")


def test_polytraj_rejects_inconsistent_lengths():
    _, traj = _traj()
    msg = encode_poly_traj(traj)
    msg = msg._replace(coef_x=msg.coef_x[:-1])
    with pytest.raises(ValueError):
        decode_poly_traj(msg, device="cpu")


def test_minco_traj_roundtrip():
    rng = np.random.default_rng(2)
    n = 5
    head = np.zeros((3, 3), np.float32)
    tail = np.zeros((3, 3), np.float32)
    tail[0] = [10.0, -1.0, 0.3]
    wps = rng.normal(0, 1, (n - 1, 3)).astype(np.float32)
    times = np.linspace(1.0, 2.0, n).astype(np.float32)
    jt = jminco.solve(*map(jnp.asarray, (times, head, tail, wps)))
    msg = encode_minco_traj(torch.as_tensor(times), head, tail, wps)
    jmsg = jio.encode_minco_traj(times, head, tail, wps)
    assert json.dumps(msg.to_dict()) == json.dumps(jmsg.to_dict())
    back = decode_minco_traj(MincoTraj.from_dict(jmsg.to_dict()),
                             device="cpu")
    jback = jio.decode_minco_traj(jio.MincoTraj.from_dict(msg.to_dict()))
    ts = np.linspace(0, float(jt.total_duration), 40)
    a = np.asarray(jtrj.eval_at(jt, jnp.asarray(ts), 0))
    b = _eval(back, ts)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        b, np.asarray(jtrj.eval_at(jback, jnp.asarray(ts), 0)), rtol=0,
        atol=1e-5)


def test_position_command_dict_is_jaxs():
    rng = np.random.default_rng(3)
    args = (0.25, *rng.normal(size=(4, 3)), 0.4, -0.1, 9, 3)
    assert PositionCommand(*args).to_dict() == \
        jio.PositionCommand(*args).to_dict()
