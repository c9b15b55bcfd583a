"""The port's host ingest against the JAX package's, on the same inputs.

- ``io.sequence``: an npz written by either package loads in the other
  (equal arrays).
- ``config``: ``to_dict`` equal; JSON and YAML written by one package read
  by the other to equal configs; an unknown section or key raises KeyError
  with the same message in both.
- ``io.lz4f``: ``compress`` gives the JAX package's bytes; each package
  decompresses the other's frames; malformed frames raise the same
  exception type in both.
- ``io.rosbag``: on the bags of tests/test_rosbag.py (``none``, ``bz2``,
  ``lz4``) ``read_bag`` gives equal messages and ``bag_to_sequence`` every
  field array-equal to the JAX package's, by the Python reader and by the
  C++ scanner of ``uslam_tpu_torch.native``; ``write_bag`` gives the JAX
  package's bytes; each malformed bag of ``TestMalformedBags`` raises
  ValueError in every reader of both packages; a 384x240 ``mono8``
  ``sensor_msgs/Image`` bag decodes to the JAX package's frames; a failed
  native build raises, where the JAX package falls back to Python.
- ``io.images``: ``load_stereo_image_dirs`` on ``.npy`` folders (name stamps,
  and frame indices with ``rate_hz``) equal to the JAX package's.
- ``io.filters``: ``smooth_imu`` on tests/test_io.py's input within 1e-5 of
  the largest value of the JAX package's and 1e-3 of scipy's;
  ``gravity_compensate`` within 1e-6 of the JAX package's.
- ``io``: the JAX package's public names, loaded without torch.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import butter as sp_butter, filtfilt as sp_filtfilt

import uslam_tpu.config as jconfig
import uslam_tpu.io as jio
from uslam_tpu.geometry.so3 import so3_exp
from uslam_tpu.io import filters as jfilters, images as jimages, lz4f as jlz4f
from uslam_tpu.io import rosbag as jrosbag, sequence as jsequence
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu_torch import config as tconfig, native
from uslam_tpu_torch.interop import config_to_port
from uslam_tpu_torch.io import filters, images, lz4f, rosbag, sequence

from tests.test_rosbag import (
    IMU_DEF,
    STRING_DEF,
    TestMalformedBags,
    _raw_record,
    _write_raw,
    make_bag,
    s_header,
    s_string,
    ser_imu,
    ser_pressure,
)

ROOT = Path(__file__).resolve().parent.parent
SEQ_ARRAYS = (
    "imu_t imu_acc imu_gyro pressure_t pressure_mbar dvl_pose_t dvl_pose_quat dvl_pose_pos "
    "dvl_twist_t dvl_twist_vel mavros_vel_t mavros_vel image_t images_left images_right "
    "gt_t gt_quat gt_pos gt_vel"
).split()


def assert_sequences_equal(a, b):
    for name in SEQ_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert len(a.features) == len(b.features)
    for fa, fb in zip(a.features, b.features):
        assert fa.t == fb.t
        for f in ("ids", "u0", "v0", "u1", "v1"):
            np.testing.assert_array_equal(getattr(fa, f), getattr(fb, f), err_msg=f)


# --- io.sequence --------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sequence_npz_crosses_packages(tmp_path, writer):
    seq = generate_synthetic_sequence(SyntheticSpec(duration=2.0, num_landmarks=24, seed=3))
    rng = np.random.default_rng(0)
    seq.image_t = seq.dvl_pose_t.copy()
    seq.images_left = rng.integers(0, 256, (len(seq.image_t), 12, 16), dtype=np.uint8)
    seq.images_right = rng.integers(0, 256, (len(seq.image_t), 12, 16), dtype=np.uint8)
    path = str(tmp_path / "seq.npz")
    save, load = (
        (jsequence.save_sequence, sequence.load_sequence) if writer == "jax"
        else (sequence.save_sequence, jsequence.load_sequence)
    )
    save(path, seq)
    assert_sequences_equal(load(path), seq)
    # The same file from the other writer, byte for byte in its arrays.
    other = str(tmp_path / "other.npz")
    (sequence.save_sequence if writer == "jax" else jsequence.save_sequence)(other, seq)
    with np.load(path) as z1, np.load(other) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        for k in z1.files:
            np.testing.assert_array_equal(z1[k], z2[k], err_msg=k)


# --- config -------------------------------------------------------------------

JAX_CFG = jconfig.UslamConfig(
    frontend=jconfig.FrontendConfig(temporal_tracker="klt", pyramid_levels=2),
    solver=jconfig.SolverConfig(max_iterations=7, f64_polish=True, reduced_solver="banded"),
    noise=jconfig.NoiseConfig(prior_pose_sigmas=(0.2, 0.2, 0.2, 0.4, 0.4, 0.4)),
)


def test_config_to_dict_matches_jax():
    assert config_to_port(JAX_CFG).to_dict() == JAX_CFG.to_dict()
    assert tconfig.UslamConfig().to_dict() == jconfig.UslamConfig().to_dict()


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_files_cross_packages(tmp_path, fmt, writer):
    path = str(tmp_path / f"cfg.{fmt}")
    port_cfg = config_to_port(JAX_CFG)
    src = JAX_CFG if writer == "jax" else port_cfg
    getattr(src, f"save_{fmt}")(path)
    assert getattr(tconfig.UslamConfig, f"from_{fmt}")(path) == port_cfg
    assert getattr(jconfig.UslamConfig, f"from_{fmt}")(path) == JAX_CFG


@pytest.mark.parametrize("bad", [{"nosuch": {}}, {"solver": {"nosuch_key": 1}}])
def test_config_unknown_names_raise_as_jax(bad):
    with pytest.raises(KeyError) as ours:
        tconfig.UslamConfig.from_dict(bad)
    with pytest.raises(KeyError) as ref:
        jconfig.UslamConfig.from_dict(bad)
    assert str(ours.value) == str(ref.value)


def test_config_yaml_partial_and_empty(tmp_path):
    p = tmp_path / "part.yaml"
    p.write_text("solver:\n  max_iterations: 9\n  linear_solver: dense\n")
    assert tconfig.UslamConfig.from_yaml(str(p)) == config_to_port(jconfig.UslamConfig.from_yaml(str(p)))
    p.write_text("")
    assert tconfig.UslamConfig.from_yaml(str(p)) == tconfig.UslamConfig()


# --- io.lz4f ------------------------------------------------------------------

LZ4_INPUTS = [
    b"",
    b"a",
    b"hello world " * 500,
    bytes(range(256)) * 40,
    np.random.default_rng(0).integers(0, 256, 7001, dtype=np.uint8).tobytes(),
    np.zeros(100000, np.uint8).tobytes(),
]


@pytest.mark.parametrize("i", range(len(LZ4_INPUTS)))
def test_lz4_frames_equal_and_cross(i):
    data = LZ4_INPUTS[i]
    ours, ref = lz4f.compress(data), jlz4f.compress(data)
    assert ours == ref
    assert lz4f.decompress(ref) == data and jlz4f.decompress(ours) == data


def _lz4_frame(body: bytes, flg: int = (1 << 6) | (1 << 5), bd: int = 7 << 4) -> bytes:
    return struct.pack("<I", 0x184D2204) + bytes([flg, bd, 0]) + body


LZ4_MALFORMED = {
    "bad magic": struct.pack("<I", 0xDEADBEEF),
    "bad match offset": _lz4_frame(
        struct.pack("<I", 4) + bytes([0x00]) + struct.pack("<H", 99) + bytes([0x00])
        + struct.pack("<I", 0)),
    "unsupported version": _lz4_frame(struct.pack("<I", 0), flg=0),
    "invalid block size": _lz4_frame(struct.pack("<I", 0), bd=1 << 4),
    "truncated block": _lz4_frame(struct.pack("<I", 100) + b"abc"),
    "literal run past end": _lz4_frame(struct.pack("<I", 2) + bytes([0x50]) + b"h"
                                       + struct.pack("<I", 0)),
    "no end mark": _lz4_frame(struct.pack("<I", 0x80000003) + b"abc"),
}


@pytest.mark.parametrize("name", sorted(LZ4_MALFORMED))
def test_lz4_malformed_raise_as_jax(name):
    data = LZ4_MALFORMED[name]
    with pytest.raises(Exception) as ref:
        jlz4f.decompress(data)
    with pytest.raises(Exception) as ours:
        lz4f.decompress(data)
    assert type(ours.value) is type(ref.value)


# --- io.rosbag ----------------------------------------------------------------


def assert_msgs_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            assert_msgs_equal(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_msgs_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_reads_equal_jax(tmp_path, compression):
    path = str(tmp_path / "ref.bag")
    make_bag(path, compression)
    ours, ref = list(rosbag.read_bag(path)), list(jrosbag.read_bag(path))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a.topic, a.type, a.t) == (b.topic, b.type, b.t)
        assert_msgs_equal(a.msg, b.msg)
    ref_seq = jrosbag.bag_to_sequence(path, use_native=False)
    for use_native in (False, True):
        assert_sequences_equal(rosbag.bag_to_sequence(path, use_native=use_native), ref_seq)


def _sensor_messages():
    """Three sensor topics and a skipped one, as (topic, type, def, t, bytes)."""
    tp = rosbag.BagTopics()
    rng = np.random.default_rng(4)
    msgs = [(tp.imu, "sensor_msgs/Imu", IMU_DEF, 0.01 * k + 0.003,
             ser_imu(0.01 * k + 0.003, rng.normal(size=3), rng.normal(size=3))) for k in range(30)]
    msgs += [(tp.pressure, "std_msgs/String", STRING_DEF, 0.1 * k, ser_pressure(0.1 * k, 1000.0 + k))
             for k in range(3)]
    msgs.append(("/rosout", "std_msgs/String", STRING_DEF, 0.05, s_string("noise")))
    return sorted(msgs, key=lambda m: m[3])


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_write_bag_bytes_equal_jax(tmp_path, compression):
    msgs = _sensor_messages()
    ours, ref = str(tmp_path / "ours.bag"), str(tmp_path / "ref.bag")
    rosbag.write_bag(ours, msgs, compression=compression)
    jrosbag.write_bag(ref, msgs, compression=compression)
    assert Path(ours).read_bytes() == Path(ref).read_bytes()


def _malformed(tmp_path, name: str) -> str:
    """The bag of TestMalformedBags.test_<name>, written the same way."""
    tp = rosbag.BagTopics()
    if name == "not_a_bag":
        path = tmp_path / "x.bag"
        path.write_bytes(b"GIF89a not a bag at all")
        return str(path)
    if name == "truncated_file":
        path = str(tmp_path / "trunc.bag")
        make_bag(path)
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:-10])
        return path
    if name == "lying_data_length":
        rec = _raw_record({"op": bytes([0x02]), "conn": struct.pack("<I", 0),
                           "time": struct.pack("<II", 1, 0)}, b"\x00" * 8, lie_dlen=10_000)
        return _write_raw(tmp_path / "dlen.bag", rec)
    if name == "lying_header_length":
        return _write_raw(tmp_path / "hlen.bag", struct.pack("<I", 10_000) + b"\x00" * 20)
    if name == "header_field_without_equals":
        hdr = struct.pack("<I", 3) + b"abc"
        return _write_raw(tmp_path / "noeq.bag",
                          struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", 0))
    if name == "unknown_op_code":
        return _write_raw(tmp_path / "badop.bag", _raw_record({"op": bytes([0x7F])}, b""))
    if name == "missing_op_field":
        return _write_raw(tmp_path / "noop.bag", _raw_record({"notop": b"x"}, b""))
    if name.startswith("corrupt_compressed_chunk"):
        compression = name.rsplit("_", 1)[1]
        path = str(tmp_path / f"corrupt_{compression}.bag")
        make_bag(path, compression)
        blob = bytearray(open(path, "rb").read())
        for i in range(len(blob) - 200, len(blob) - 120):
            blob[i] ^= 0xA5
        open(path, "wb").write(bytes(blob))
        return path
    if name == "truncated_message_payload":
        path = str(tmp_path / "badmsg.bag")
        rosbag.write_bag(path, [(tp.pressure, "std_msgs/String", STRING_DEF, 1.0,
                                 struct.pack("<I", 100) + b"hi")])
        return path
    if name == "lying_array_count":
        from tests.test_rosbag import CAMERA_MEAS_DEF

        path = str(tmp_path / "badcount.bag")
        rosbag.write_bag(path, [(tp.features, "gtsam_vio/CameraMeasurement", CAMERA_MEAS_DEF,
                                 1.0, s_header(1.0) + struct.pack("<I", 0xFFFF_FFF0))])
        return path
    raise KeyError(name)


MALFORMED = sorted(
    n[len("test_"):] for n in vars(TestMalformedBags) if n.startswith("test_")
    and n != "test_corrupt_compressed_chunk"
) + ["corrupt_compressed_chunk_bz2", "corrupt_compressed_chunk_lz4"]


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_bags_raise_value_error(tmp_path, name):
    path = _malformed(tmp_path, name)
    readers = {
        "read_bag": lambda m: list(m.read_bag(path)),
        "bag_to_sequence python": lambda m: m.bag_to_sequence(path, use_native=False),
        "bag_to_sequence native": lambda m: m.bag_to_sequence(path, use_native=True),
    }
    for label, read in readers.items():
        with pytest.raises(ValueError):
            read(jrosbag)
        with pytest.raises(ValueError):
            read(rosbag)


IMAGE_DEF = """\
Header header
uint32 height
uint32 width
string encoding
uint8 is_bigendian
uint32 step
uint8[] data
"""


def ser_image_mono8(t, img):
    h, w = img.shape
    return (s_header(t) + struct.pack("<II", h, w) + s_string("mono8")
            + struct.pack("<BI", 0, w) + struct.pack("<I", h * w) + img.tobytes())


def test_mono8_image_bag_decodes_as_jax(tmp_path):
    tp = rosbag.BagTopics(image_left="/left/image_raw", image_right="/right/image_raw")
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 3, 240, 384), dtype=np.uint8)
    msgs = _sensor_messages()
    for k in range(frames.shape[1]):
        t = 0.05 + 0.2 * k
        msgs.append((tp.image_left, "sensor_msgs/Image", IMAGE_DEF, t, ser_image_mono8(t, frames[0, k])))
        msgs.append((tp.image_right, "sensor_msgs/Image", IMAGE_DEF, t, ser_image_mono8(t, frames[1, k])))
    path = str(tmp_path / "imagery.bag")
    rosbag.write_bag(path, sorted(msgs, key=lambda m: m[3]), compression="bz2")
    jtp = jrosbag.BagTopics(image_left=tp.image_left, image_right=tp.image_right)
    ref = jrosbag.bag_to_sequence(path, topics=jtp, decode_images=True)
    ours = rosbag.bag_to_sequence(path, topics=tp, decode_images=True)
    assert_sequences_equal(ours, ref)
    np.testing.assert_array_equal(ours.images_left, frames[0].astype(np.float32))
    np.testing.assert_array_equal(ours.images_right, frames[1].astype(np.float32))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "bagparse.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    path = str(tmp_path / "ref.bag")
    make_bag(path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rosbag.bag_to_sequence(path, use_native=True)
    assert rosbag.bag_to_sequence(path, use_native=False).imu_t.shape == (40,)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_native_reader_on_the_card_machine(cuda, tmp_path):
    """The C++ scanner built on the GPU machine's toolchain equals the
    Python reader there."""
    path = str(tmp_path / "ref.bag")
    make_bag(path, "bz2")
    assert_sequences_equal(rosbag.bag_to_sequence(path, use_native=True),
                           rosbag.bag_to_sequence(path, use_native=False))


# --- io.images ----------------------------------------------------------------


@pytest.mark.parametrize("names", ["stamps", "indices"])
def test_image_dirs_match_jax(tmp_path, names):
    ld, rd = tmp_path / "left", tmp_path / "right"
    ld.mkdir()
    rd.mkdir()
    rng = np.random.default_rng(1)
    for i in range(4):
        stem = f"{1678901234.5 + 0.25 * i:.3f}" if names == "stamps" else f"{i:06d}"
        np.save(ld / f"{stem}.npy", rng.uniform(0, 255, (24, 32)).astype(np.float32))
        np.save(rd / f"{stem}.npy", rng.integers(0, 256, (24, 32, 3)).astype(np.uint8))
    ours = images.load_stereo_image_dirs(str(ld), str(rd), rate_hz=10.0)
    ref = jimages.load_stereo_image_dirs(str(ld), str(rd), rate_hz=10.0)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    expect = 1678901234.5 + 0.25 * np.arange(4) if names == "stamps" else np.arange(4) / 10.0
    np.testing.assert_allclose(ours[0], expect)


# --- io.filters ---------------------------------------------------------------


def test_butter_coefficients_equal_jax():
    for ours, ref in zip(filters.butter_lowpass_coeffs(3, 0.5, 30.0),
                         jfilters.butter_lowpass_coeffs(3, 0.5, 30.0)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_smooth_imu_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(300, 6)), axis=0).astype(np.float32)
    ours = filters.smooth_imu(x, device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    ours = ours.numpy()
    ref = np.asarray(jfilters.smooth_imu(x))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    b_sp, a_sp = sp_butter(3, 0.5 / 15.0)
    sp = sp_filtfilt(b_sp, a_sp, x.T).T
    assert np.abs(ours - sp).max() <= 1e-3 * np.abs(sp).max()


def test_gravity_compensate_matches_jax():
    rng = np.random.default_rng(2)
    acc = rng.normal(0, 3, (50, 3)).astype(np.float32)
    q = np.asarray(so3_exp(jnp.asarray(rng.normal(0, 1, (50, 3)), jnp.float32)))
    ref = np.asarray(jfilters.gravity_compensate(jnp.asarray(acc), jnp.asarray(q)))
    ours = filters.gravity_compensate(torch.from_numpy(acc), torch.tensor(q)).numpy()
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


# --- io -----------------------------------------------------------------------


def test_io_exports_jax_names_without_torch():
    import uslam_tpu_torch.io as tio

    jnames = {n for n in vars(jio) if not n.startswith("_") and not isinstance(getattr(jio, n), type(jio))}
    assert jnames == set(tio.__all__)
    for name in jnames:
        assert getattr(tio, name).__name__ == getattr(jio, name).__name__
    code = ("import sys, uslam_tpu_torch.io as io\n"
            "io.SensorSequence, io.bag_to_sequence, io.load_sequence\n"
            "assert 'torch' not in sys.modules, 'torch'\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=60)
    assert out.stdout.strip() == "ok", out.stderr
