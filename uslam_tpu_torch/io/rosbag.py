"""ROS1 bag (v2.0) reader and writer — no ROS installation required (the
JAX package's ``uslam_tpu.io.rosbag``, copied so the port imports nothing
of it; its tests hold the two equal).

The reference consumes its data as a rosbag played through roscore
(reference README.md:52, batch.py:319-326). This module lets a user of the
reference point this framework directly at the same ``.bag`` file:

- a rosbag v2.0 record/chunk parser (``read_bag``), supporting ``none`` and
  ``bz2`` and ``lz4`` chunk compression (lz4 via the pure-Python frame
  codec in :mod:`uslam_tpu_torch.io.lz4f` when the lz4 package is absent);
- a generic ROS1 binary message deserializer compiled from the message
  definition text embedded in each bag connection record — so custom types
  (e.g. ``gtsam_vio/CameraMeasurement``, the feature message at
  batch.py:29,323) decode without their .msg files;
- ``bag_to_sequence``: the reference's topic surface (batch.py:319-326)
  mapped into a :class:`~uslam_tpu_torch.io.sequence.SensorSequence`, by
  this Python reader or by the C++ scanner of :mod:`uslam_tpu_torch.native`;
- a minimal ``write_bag`` (one chunk, uncompressed, bz2 or lz4) used by
  tests and for exporting sequences back to bag form.

Wire format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""

from __future__ import annotations

import bz2
import json
import struct
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple

import numpy as np

from uslam_tpu_torch.io.sequence import FeatureFrame, SensorSequence

# --- low-level record I/O ---------------------------------------------------

_MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_fields(buf: bytes) -> dict:
    """name=value fields of a record header (or connection header).

    Raises :class:`ValueError` on malformed input (a length field that
    overruns the buffer, or an item with no ``=``) — bags are untrusted
    binary input and must fail loudly, never silently truncate.
    """
    fields = {}
    off = 0
    n = len(buf)
    while off < n:
        if off + 4 > n:
            raise ValueError("rosbag: truncated header field length")
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if flen > n - off:
            raise ValueError(
                f"rosbag: header field length {flen} overruns buffer "
                f"({n - off} bytes left)"
            )
        item = buf[off : off + flen]
        off += flen
        eq = item.find(b"=")
        if eq < 0:
            raise ValueError("rosbag: malformed header field (no '=')")
        fields[item[:eq].decode()] = item[eq + 1 :]
    return fields


def _encode_fields(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _iter_records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    """Yield (header_fields, data) records; :class:`ValueError` on a record
    whose length fields lie (overrun the buffer) or whose tail is truncated."""
    off = 0
    n = len(buf)
    while off < n:
        if off + 4 > n:
            raise ValueError("rosbag: truncated record (header length)")
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if hlen > n - off:
            raise ValueError(
                f"rosbag: record header length {hlen} overruns buffer "
                f"({n - off} bytes left)"
            )
        header = _parse_fields(buf[off : off + hlen])
        off += hlen
        if off + 4 > n:
            raise ValueError("rosbag: truncated record (data length)")
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if dlen > n - off:
            raise ValueError(
                f"rosbag: record data length {dlen} overruns buffer "
                f"({n - off} bytes left)"
            )
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


def _decompress(data: bytes, compression: str) -> bytes:
    if compression in ("none", ""):
        return data
    if compression == "bz2":
        try:
            return bz2.decompress(data)
        except (OSError, ValueError, EOFError) as e:
            raise ValueError(f"rosbag: corrupt bz2 chunk: {e}") from e
    if compression == "lz4":
        try:  # C-accelerated package when present
            import lz4.frame
        except ImportError:
            from uslam_tpu_torch.io import lz4f

            try:
                return lz4f.decompress(data)
            except (ValueError, IndexError, struct.error) as e:
                raise ValueError(f"rosbag: corrupt lz4 chunk: {e}") from e
        return lz4.frame.decompress(data)  # pragma: no cover - not in image
    raise ValueError(f"unknown chunk compression {compression!r}")


# --- ROS1 message schema (compiled from embedded definition text) -----------

_PRIMITIVES = {
    "bool": ("B", 1), "byte": ("b", 1), "char": ("B", 1),
    "int8": ("b", 1), "uint8": ("B", 1),
    "int16": ("h", 2), "uint16": ("H", 2),
    "int32": ("i", 4), "uint32": ("I", 4),
    "int64": ("q", 8), "uint64": ("Q", 8),
    "float32": ("f", 4), "float64": ("d", 8),
}
_NP_DTYPE = {
    "bool": np.bool_, "byte": np.int8, "char": np.uint8,
    "int8": np.int8, "uint8": np.uint8, "int16": np.int16,
    "uint16": np.uint16, "int32": np.int32, "uint32": np.uint32,
    "int64": np.int64, "uint64": np.uint64,
    "float32": np.float32, "float64": np.float64,
}


class MessageSchema:
    """Deserializer for one ROS1 message type, compiled from the definition
    text a bag stores in its connection records.

    Consecutive fixed-size primitive fields are merged into a single
    ``struct`` unpack; primitive arrays decode via ``np.frombuffer`` — this
    keeps 200 Hz IMU streams cheap to parse in pure Python.
    """

    def __init__(self, type_name: str, definition: str):
        blocks = self._split_blocks(definition)
        self._types = {}  # short + full names -> field list
        root_fields = None
        for name, lines in blocks:
            fields = self._parse_block(lines)
            if name is None:
                root_fields = fields
            else:
                self._types[name] = fields
                if "/" in name:
                    self._types[name.split("/")[-1]] = fields
        # std_msgs/Header is implicitly known even if not embedded.
        hdr = [("uint32", "seq", None), ("time", "stamp", None), ("string", "frame_id", None)]
        self._types.setdefault("std_msgs/Header", hdr)
        self._types.setdefault("Header", hdr)
        self.type_name = type_name
        self._ops = self._compile(root_fields)

    @staticmethod
    def _split_blocks(definition: str):
        blocks, cur_name, cur = [], None, []
        for line in definition.splitlines():
            if line.startswith("="):  # separator of concatenated defs
                blocks.append((cur_name, cur))
                cur_name, cur = None, []
            elif line.startswith("MSG:"):
                cur_name = line.split(":", 1)[1].strip()
            else:
                cur.append(line)
        blocks.append((cur_name, cur))
        return blocks

    @staticmethod
    def _parse_block(lines):
        fields = []
        for raw in lines:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            ftype, rest = parts
            if "=" in rest:  # constant declaration
                continue
            count = None
            if "[" in ftype:
                base, sub = ftype.split("[", 1)
                sub = sub.rstrip("]")
                count = -1 if sub == "" else int(sub)
                ftype = base
            fields.append((ftype, rest.strip(), count))
        return fields

    def _resolve(self, ftype: str):
        if ftype in self._types:
            return self._types[ftype]
        raise KeyError(f"unknown message type {ftype!r} in {self.type_name}")

    def _compile(self, fields):
        """Field list -> op list. Ops:
        ('struct', fmt, size, names), ('string', name),
        ('nparray', name, dtype, itemsize, count_or_-1),
        ('strarray', name, count_or_-1),
        ('msg', name, ops), ('msgarray', name, ops, count_or_-1)."""
        ops, pend_fmt, pend_names = [], "", []

        def flush():
            nonlocal pend_fmt, pend_names
            if pend_names:
                fmt = "<" + pend_fmt
                ops.append(("struct", fmt, struct.calcsize(fmt), tuple(pend_names)))
                pend_fmt, pend_names = "", []

        for ftype, name, count in fields:
            if ftype in ("time", "duration") and count is None:
                pend_fmt += "II" if ftype == "time" else "ii"
                pend_names.append(("__ts__", name))
            elif ftype in _PRIMITIVES and count is None:
                pend_fmt += _PRIMITIVES[ftype][0]
                pend_names.append(name)
            elif ftype == "string" and count is None:
                flush()
                ops.append(("string", name))
            elif ftype in _PRIMITIVES and count is not None:
                flush()
                dt = np.dtype(_NP_DTYPE[ftype]).newbyteorder("<")
                ops.append(("nparray", name, dt, dt.itemsize, count))
            elif ftype == "string":
                flush()
                ops.append(("strarray", name, count))
            else:
                flush()
                sub_ops = self._compile(self._resolve(ftype))
                if count is None:
                    ops.append(("msg", name, sub_ops))
                else:
                    ops.append(("msgarray", name, sub_ops, count))
        flush()
        return ops

    def deserialize(self, buf: bytes, offset: int = 0) -> dict:
        try:
            msg, _ = self._run(self._ops, buf, offset)
        except struct.error as e:
            raise ValueError(
                f"rosbag: truncated {self.type_name} message: {e}"
            ) from e
        return msg

    def _run(self, ops, buf, off):
        n = len(buf)
        out = {}
        for op in ops:
            kind = op[0]
            if kind == "struct":
                _, fmt, size, names = op
                vals = struct.unpack_from(fmt, buf, off)
                off += size
                vi = 0
                for nm in names:
                    if isinstance(nm, tuple):  # time/duration: two words
                        out[nm[1]] = vals[vi] + vals[vi + 1] * 1e-9
                        vi += 2
                    else:
                        out[nm] = vals[vi]
                        vi += 1
            elif kind == "string":
                (slen,) = struct.unpack_from("<I", buf, off)
                off += 4
                if slen > n - off:
                    raise ValueError(
                        f"rosbag: string length {slen} overruns "
                        f"{self.type_name} message ({n - off} bytes left)"
                    )
                out[op[1]] = buf[off : off + slen].decode(errors="replace")
                off += slen
            elif kind == "nparray":
                _, name, dt, isz, count = op
                if count < 0:
                    (count,) = struct.unpack_from("<I", buf, off)
                    off += 4
                if isz * count > n - off:
                    raise ValueError(
                        f"rosbag: array of {count} x {isz}B overruns "
                        f"{self.type_name} message ({n - off} bytes left)"
                    )
                out[name] = np.frombuffer(buf, dt, count, off).copy()
                off += isz * count
            elif kind == "strarray":
                _, name, count = op
                if count < 0:
                    (count,) = struct.unpack_from("<I", buf, off)
                    off += 4
                if 4 * count > n - off:  # each item carries >= a length word
                    raise ValueError(
                        f"rosbag: string array count {count} overruns "
                        f"{self.type_name} message"
                    )
                items = []
                for _ in range(count):
                    (slen,) = struct.unpack_from("<I", buf, off)
                    off += 4
                    if slen > n - off:
                        raise ValueError(
                            f"rosbag: string length {slen} overruns "
                            f"{self.type_name} message ({n - off} bytes left)"
                        )
                    items.append(buf[off : off + slen].decode(errors="replace"))
                    off += slen
                out[name] = items
            elif kind == "msg":
                out[op[1]], off = self._run(op[2], buf, off)
            else:  # msgarray
                _, name, sub_ops, count = op
                if count < 0:
                    (count,) = struct.unpack_from("<I", buf, off)
                    off += 4
                # A lying count field must not drive an unbounded loop: even
                # zero-size submessages are capped by one-byte-per-item here.
                if count > n - off:
                    raise ValueError(
                        f"rosbag: message array count {count} overruns "
                        f"{self.type_name} message ({n - off} bytes left)"
                    )
                items = []
                for _ in range(count):
                    item, off = self._run(sub_ops, buf, off)
                    items.append(item)
                out[name] = items
        return out, off


# --- reading ----------------------------------------------------------------


class BagMessage(NamedTuple):
    topic: str
    type: str
    t: float          # record receive time (seconds)
    msg: dict


class _Connection(NamedTuple):
    topic: str
    type: str
    schema: MessageSchema


def read_bag(path: str, topics=None) -> Iterator[BagMessage]:
    """Stream messages from a rosbag v2.0 in on-disk order.

    ``topics``: optional collection restricting which topics are parsed
    (others are skipped without deserialization — skipping is cheap).
    """
    want = set(topics) if topics is not None else None
    conns: dict[int, _Connection | None] = {}

    def handle_connection(header, data):
        cid = struct.unpack("<I", header["conn"])[0]
        if cid in conns:
            return
        chdr = _parse_fields(data)
        topic = chdr.get("topic", header.get("topic", b"")).decode()
        tname = chdr["type"].decode()
        if want is not None and topic not in want:
            conns[cid] = None
            return
        schema = MessageSchema(tname, chdr.get("message_definition", b"").decode())
        conns[cid] = _Connection(topic, tname, schema)

    def handle_message(header, data):
        cid = struct.unpack("<I", header["conn"])[0]
        conn = conns.get(cid)
        if conn is None:
            return None
        secs, nsecs = struct.unpack("<II", header["time"])
        return BagMessage(conn.topic, conn.type, secs + nsecs * 1e-9,
                          conn.schema.deserialize(data))

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        buf = f.read()

    _KNOWN_OPS = (OP_MESSAGE, OP_BAG_HEADER, OP_INDEX, OP_CHUNK,
                  OP_CHUNK_INFO, OP_CONNECTION)

    def record_op(header: dict) -> int:
        op_field = header.get("op")
        if not op_field:
            raise ValueError("rosbag: record missing 'op' header field")
        op = op_field[0]
        if op not in _KNOWN_OPS:
            # v2.0 is a frozen format: an op outside 0x02-0x07 is corruption,
            # not a future extension.
            raise ValueError(f"rosbag: unknown record op 0x{op:02x}")
        return op

    for header, data in _iter_records(buf):
        op = record_op(header)
        if op == OP_CHUNK:
            if "compression" not in header:
                raise ValueError("rosbag: chunk record missing 'compression'")
            inner = _decompress(data, header["compression"].decode())
            for ih, idata in _iter_records(inner):
                iop = record_op(ih)
                if iop == OP_CONNECTION:
                    handle_connection(ih, idata)
                elif iop == OP_MESSAGE:
                    out = handle_message(ih, idata)
                    if out is not None:
                        yield out
        elif op == OP_CONNECTION:
            handle_connection(header, data)
        elif op == OP_MESSAGE:  # unchunked bags (spec-legal)
            out = handle_message(header, data)
            if out is not None:
                yield out
        # OP_INDEX / OP_CHUNK_INFO / OP_BAG_HEADER: sequential read needs none.


# --- reference topic surface -> SensorSequence ------------------------------


@dataclass
class BagTopics:
    """Topic names, defaulting to the reference's (batch.py:319-326,
    stereo.launch:24-26,51-53)."""

    imu: str = "/zedm/zed_node/imu/data"
    pressure: str = "/BlueROV/pressure2"
    dvl_pose: str = "/dvl/local_position"
    dvl_twist: str = "/dvl/twist"
    features: str = "/auv/image_processor/features"
    # isam-only ENU velocity stream (reference isam.py:365).
    mavros_vel: str = "/mavros/local_position/velocity_local"
    image_left: str | None = None    # e.g. /zedm/zed_node/left/image_rect_color
    image_right: str | None = None


def _decode_image(msg: dict, type_name: str) -> np.ndarray | None:
    """sensor_msgs/{Image,CompressedImage} -> grayscale float array."""
    if type_name.endswith("CompressedImage"):
        try:
            import cv2
        except ImportError:  # pragma: no cover
            return None
        img = cv2.imdecode(np.frombuffer(msg["data"], np.uint8), cv2.IMREAD_GRAYSCALE)
        return None if img is None else img.astype(np.float32)
    h, w = msg["height"], msg["width"]
    enc = msg.get("encoding", "mono8")
    data = np.asarray(msg["data"], np.uint8)
    ch = {"mono8": 1, "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}.get(enc)
    if ch is None:
        return None
    img = data.reshape(h, msg["step"] // ch if ch > 1 else msg["step"], -1)[:h, :w]
    if ch == 1:
        return img[..., 0].astype(np.float32)
    # luma from the first three channels (order-insensitive average is fine
    # for feature detection; exact colorimetric weights don't matter here)
    return img[..., :3].mean(axis=-1).astype(np.float32)


def bag_to_sequence(
    path: str,
    topics: BagTopics | None = None,
    decode_images: bool = False,
    use_native: bool = True,
) -> SensorSequence:
    """Read a reference-style bag into a :class:`SensorSequence`.

    Field mapping mirrors the reference callbacks exactly:
    - IMU linear_acceleration + angular_velocity (batch.py:138-141),
    - pressure ``press_abs`` mbar from the JSON String payload (batch.py:122-126),
    - DVL pose position + orientation (batch.py:128-136),
    - DVL twist linear velocity (batch.py:241-250),
    - feature tracks id/u0/v0/u1/v1 in normalized coords (batch.py:144-176).
    Timestamps use the message header stamp when present, falling back to
    the bag receive time (the reference's synchronizer keys on the same).

    ``use_native``: route the record scan and the fixed-layout streams
    (IMU / DVL pose / DVL twist — the high-rate ones) through the C++
    scanner (:mod:`uslam_tpu_torch.native`), equal to this Python path
    array for array (tested). Its library is built with g++ at first use;
    a failed build raises (the JAX package falls back to Python here).
    Image topics decode on the Python path whatever ``use_native`` says.
    """
    tp = topics or BagTopics()
    if use_native and not (decode_images and tp.image_left):
        return _bag_to_sequence_native(path, tp)
    want = [tp.imu, tp.pressure, tp.dvl_pose, tp.dvl_twist, tp.features,
            tp.mavros_vel]
    if decode_images and tp.image_left and tp.image_right:
        want += [tp.image_left, tp.image_right]

    imu_t, imu_acc, imu_gyro = [], [], []
    pr_t, pr_mbar = [], []
    dp_t, dp_quat, dp_pos = [], [], []
    dt_t, dt_vel = [], []
    mv_t, mv_vel = [], []
    features: list[FeatureFrame] = []
    img_t, img_l, img_r = [], {}, {}

    def stamp(m: BagMessage) -> float:
        hdr = m.msg.get("header")
        if isinstance(hdr, dict) and hdr.get("stamp", 0.0) > 0.0:
            return float(hdr["stamp"])
        return m.t

    for m in read_bag(path, topics=[t for t in want if t]):
        if m.topic == tp.imu:
            imu_t.append(stamp(m))
            a, g = m.msg["linear_acceleration"], m.msg["angular_velocity"]
            imu_acc.append((a["x"], a["y"], a["z"]))
            imu_gyro.append((g["x"], g["y"], g["z"]))
        elif m.topic == tp.pressure:
            try:
                mbar = json.loads(m.msg["data"])["press_abs"]
            except (ValueError, KeyError, TypeError):
                continue  # malformed payload: drop (reference would crash)
            pr_t.append(stamp(m))
            pr_mbar.append(float(mbar))
        elif m.topic == tp.dvl_pose:
            pose = m.msg["pose"]
            pose = pose.get("pose", pose)  # PoseWithCovariance -> Pose
            p, q = pose["position"], pose["orientation"]
            dp_t.append(stamp(m))
            dp_quat.append((q["w"], q["x"], q["y"], q["z"]))
            dp_pos.append((p["x"], p["y"], p["z"]))
        elif m.topic in (tp.dvl_twist, tp.mavros_vel):
            tw = m.msg["twist"]
            tw = tw.get("twist", tw)
            lin = tw["linear"]
            if m.topic == tp.dvl_twist:
                dt_t.append(stamp(m))
                dt_vel.append((lin["x"], lin["y"], lin["z"]))
            else:
                mv_t.append(stamp(m))
                mv_vel.append((lin["x"], lin["y"], lin["z"]))
        elif m.topic == tp.features:
            feats = m.msg.get("features", [])
            features.append(
                FeatureFrame(
                    t=stamp(m),
                    ids=np.array([f["id"] for f in feats], np.int64),
                    u0=np.array([f["u0"] for f in feats]),
                    v0=np.array([f["v0"] for f in feats]),
                    u1=np.array([f["u1"] for f in feats]),
                    v1=np.array([f["v1"] for f in feats]),
                )
            )
        elif m.topic in (tp.image_left, tp.image_right):
            img = _decode_image(m.msg, m.type)
            if img is None:
                continue
            side = img_l if m.topic == tp.image_left else img_r
            side[round(stamp(m), 4)] = img

    if decode_images and img_l and img_r:
        common = sorted(set(img_l) & set(img_r))
        img_t = np.array(common)
        left = np.stack([img_l[t] for t in common]) if common else None
        right = np.stack([img_r[t] for t in common]) if common else None
    else:
        img_t, left, right = None, None, None

    def arr(x, shape1=None):
        a = np.asarray(x, np.float64)
        return a if a.size else np.zeros((0,) + (shape1 or ()), np.float64)

    return SensorSequence(
        imu_t=arr(imu_t), imu_acc=arr(imu_acc, (3,)), imu_gyro=arr(imu_gyro, (3,)),
        pressure_t=arr(pr_t), pressure_mbar=arr(pr_mbar),
        dvl_pose_t=arr(dp_t), dvl_pose_quat=arr(dp_quat, (4,)),
        dvl_pose_pos=arr(dp_pos, (3,)),
        dvl_twist_t=arr(dt_t), dvl_twist_vel=arr(dt_vel, (3,)),
        features=features,
        mavros_vel_t=arr(mv_t) if mv_t else None,
        mavros_vel=arr(mv_vel, (3,)) if mv_vel else None,
        image_t=img_t, images_left=left, images_right=right,
    )


# --- native fast path ---------------------------------------------------------

# (opcode, arg) programs for the fixed-layout standard types, executed by
# native/bagparse.cpp::bag_decode_fixed. Ops: 0 skip bytes, 1 skip string,
# 2 read time -> 1 double, 3 read N float64. Layouts follow the public ROS
# message definitions (header seq + stamp + frame_id, then fields in order).
_FIXED_PROGRAMS = {
    # -> [stamp, quat xyzw(4), gyro(3), acc(3)]
    "sensor_msgs/Imu": (
        [(0, 4), (2, 0), (1, 0), (3, 4), (0, 72), (3, 3), (0, 72), (3, 3), (0, 72)],
        11,
    ),
    # -> [stamp, pos(3), quat xyzw(4)]
    "geometry_msgs/PoseWithCovarianceStamped": (
        [(0, 4), (2, 0), (1, 0), (3, 7), (0, 288)],
        8,
    ),
    # -> [stamp, linear(3), angular(3)]
    "geometry_msgs/TwistStamped": ([(0, 4), (2, 0), (1, 0), (3, 6)], 7),
}


def _bag_to_sequence_native(path: str, tp: BagTopics) -> SensorSequence:
    """C++-scanned variant of :func:`bag_to_sequence` (no image decode)."""
    from uslam_tpu_torch import native

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        whole = np.frombuffer(f.read(), np.uint8)

    want = {t for t in (tp.imu, tp.pressure, tp.dvl_pose, tp.dvl_twist,
                        tp.features, tp.mavros_vel) if t}
    conns: dict[int, _Connection | None] = {}
    buffers: list[np.ndarray] = []

    def handle_conn(buf, h_off, h_len, d_off, d_len, conn_id):
        if conn_id in conns:
            return
        hdr = _parse_fields(bytes(buf[h_off : h_off + h_len]))
        chdr = _parse_fields(bytes(buf[d_off : d_off + d_len]))
        topic = chdr.get("topic", hdr.get("topic", b"")).decode()
        tname = chdr["type"].decode()
        if topic not in want:
            conns[conn_id] = None
            return
        # Fixed-layout streams skip schema compilation entirely.
        schema = (
            None
            if tname in _FIXED_PROGRAMS
            else MessageSchema(tname, chdr.get("message_definition", b"").decode())
        )
        conns[conn_id] = _Connection(topic, tname, schema)

    # Per scanned buffer: (bidx, cids, times, d_off, d_len) message arrays —
    # kept vectorized; a Python loop only touches the few non-message records.
    per_buf: list[tuple] = []

    def scan(buf: np.ndarray, bidx: int):
        ops, cids, times, h_off, h_len, d_off, d_len = native.bag_scan_records(buf)
        # The C++ scanner STOPS (rather than overrunning) at a record whose
        # length fields lie or whose tail is truncated; unconsumed bytes
        # therefore mean a corrupt bag, and must raise — same contract as
        # the pure-Python _iter_records path.
        end = int(d_off[-1] + d_len[-1]) if len(ops) else 0
        if end != len(buf):
            raise ValueError(
                f"rosbag: truncated or corrupt record at byte {end} "
                f"({len(buf) - end} trailing bytes unparseable)"
            )
        if (ops == 0).any() or not np.isin(
            ops, (OP_MESSAGE, OP_BAG_HEADER, OP_INDEX, OP_CHUNK,
                  OP_CHUNK_INFO, OP_CONNECTION)
        ).all():
            bad = ops[~np.isin(ops, (OP_MESSAGE, OP_BAG_HEADER, OP_INDEX,
                                     OP_CHUNK, OP_CHUNK_INFO, OP_CONNECTION))]
            raise ValueError(f"rosbag: unknown record op 0x{int(bad[0]):02x}")
        for j in np.nonzero(ops != OP_MESSAGE)[0]:
            op = ops[j]
            if op == OP_CONNECTION:
                handle_conn(buf, int(h_off[j]), int(h_len[j]), int(d_off[j]),
                            int(d_len[j]), int(cids[j]))
            elif op == OP_CHUNK:
                hdr = _parse_fields(bytes(buf[h_off[j] : h_off[j] + h_len[j]]))
                comp = hdr.get("compression", b"none").decode()
                if comp in ("none", ""):
                    inner = buf[d_off[j] : d_off[j] + d_len[j]]  # zero-copy view
                else:
                    inner = np.frombuffer(
                        _decompress(bytes(buf[d_off[j] : d_off[j] + d_len[j]]), comp),
                        np.uint8,
                    )
                buffers.append(inner)
                scan(inner, len(buffers) - 1)
        mm = ops == OP_MESSAGE
        if mm.any():
            per_buf.append((bidx, cids[mm], times[mm], d_off[mm], d_len[mm]))

    buffers.append(whole)
    scan(whole, 0)

    def _msg_locations(cid_set: set):
        """Vectorized: per buffer, the (offs, lens, times) of cids in the set."""
        out = []
        for bidx, cids, times, offs, lens in per_buf:
            m = np.isin(cids, list(cid_set))
            if m.any():
                out.append((bidx, offs[m], lens[m], times[m]))
        return out

    def stream(topic: str):
        """Concatenated (columns, rec_times) for a fixed-layout topic."""
        rows, rts = [], []
        by_type: dict[str, set] = {}
        for cid, conn in conns.items():
            if conn is not None and conn.topic == topic:
                by_type.setdefault(conn.type, set()).add(cid)
        for tname, cid_set in by_type.items():
            prog, out_w = _FIXED_PROGRAMS[tname]
            for bidx, offs, lens, times in _msg_locations(cid_set):
                out, n_ok = native.bag_decode_fixed(buffers[bidx], offs, lens, prog, out_w)
                rows.append(out[:n_ok])
                rts.append(times[:n_ok])
        if not rows:
            return np.zeros((0, 1)), np.zeros(0)
        return np.concatenate(rows), np.concatenate(rts)

    def with_stamp_fallback(cols, rts):
        t = cols[:, 0].copy()
        t[t <= 0.0] = rts[t <= 0.0]
        return t

    imu, imu_rt = stream(tp.imu)
    pose, pose_rt = stream(tp.dvl_pose)
    twist, twist_rt = stream(tp.dvl_twist)
    mav, mav_rt = stream(tp.mavros_vel) if tp.mavros_vel else (np.zeros((0, 1)), np.zeros(0))

    # Generic (schema-decoded) low-rate streams: pressure JSON + features.
    pr_t, pr_mbar = [], []
    features: list[FeatureFrame] = []
    for cid, conn in conns.items():
        if conn is None or conn.schema is None:
            continue
        for bidx, offs, lens, times in _msg_locations({cid}):
            for off, ln, rt in zip(offs, lens, times):
                payload = bytes(buffers[bidx][off : off + ln])
                msg = conn.schema.deserialize(payload)
                hdr = msg.get("header")
                t = hdr["stamp"] if isinstance(hdr, dict) and hdr.get("stamp", 0.0) > 0 else float(rt)
                if conn.topic == tp.pressure:
                    try:
                        mbar = json.loads(msg["data"])["press_abs"]
                    except (ValueError, KeyError, TypeError):
                        continue
                    pr_t.append(t)
                    pr_mbar.append(float(mbar))
                elif conn.topic == tp.features:
                    feats = msg.get("features", [])
                    features.append(
                        FeatureFrame(
                            t=t,
                            ids=np.array([f["id"] for f in feats], np.int64),
                            u0=np.array([f["u0"] for f in feats]),
                            v0=np.array([f["v0"] for f in feats]),
                            u1=np.array([f["u1"] for f in feats]),
                            v1=np.array([f["v1"] for f in feats]),
                        )
                    )

    def arr(x, shape1=None):
        a = np.asarray(x, np.float64)
        return a if a.size else np.zeros((0,) + (shape1 or ()), np.float64)

    # Column order from _FIXED_PROGRAMS: Imu [t,qxyzw,gyro,acc];
    # pose [t,pos,qxyzw]; twist [t,linear,angular]. Quats -> wxyz.
    return SensorSequence(
        imu_t=with_stamp_fallback(imu, imu_rt) if len(imu) else np.zeros(0),
        imu_acc=imu[:, 8:11] if len(imu) else np.zeros((0, 3)),
        imu_gyro=imu[:, 5:8] if len(imu) else np.zeros((0, 3)),
        pressure_t=arr(pr_t),
        pressure_mbar=arr(pr_mbar),
        dvl_pose_t=with_stamp_fallback(pose, pose_rt) if len(pose) else np.zeros(0),
        dvl_pose_quat=pose[:, [7, 4, 5, 6]] if len(pose) else np.zeros((0, 4)),
        dvl_pose_pos=pose[:, 1:4] if len(pose) else np.zeros((0, 3)),
        dvl_twist_t=with_stamp_fallback(twist, twist_rt) if len(twist) else np.zeros(0),
        dvl_twist_vel=twist[:, 1:4] if len(twist) else np.zeros((0, 3)),
        features=features,
        mavros_vel_t=with_stamp_fallback(mav, mav_rt) if len(mav) else None,
        mavros_vel=mav[:, 1:4] if len(mav) else None,
    )


# --- minimal writer (tests / export) ----------------------------------------


def write_bag(
    path: str,
    messages: list[tuple[str, str, str, float, bytes]],
    compression: str = "none",
) -> None:
    """Write a single-chunk rosbag v2.0 (compression: "none", "bz2", "lz4").

    ``messages``: (topic, type_name, message_definition, t, serialized_bytes).
    Enough of the format for this module's reader and for offline archival;
    no index records are written (rosbag CLI would want a reindex).
    """
    conn_ids: dict[str, int] = {}
    parts: list[bytes] = []

    def record(header: dict, data: bytes) -> bytes:
        h = _encode_fields(header)
        return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data

    for topic, tname, mdef, t, payload in messages:
        if topic not in conn_ids:
            cid = len(conn_ids)
            conn_ids[topic] = cid
            chdr = _encode_fields(
                {
                    "topic": topic.encode(),
                    "type": tname.encode(),
                    "md5sum": b"*",
                    "message_definition": mdef.encode(),
                }
            )
            parts.append(
                record(
                    {"op": bytes([OP_CONNECTION]),
                     "conn": struct.pack("<I", cid),
                     "topic": topic.encode()},
                    chdr,
                )
            )
        secs = int(t)
        nsecs = int(round((t - secs) * 1e9))
        parts.append(
            record(
                {"op": bytes([OP_MESSAGE]),
                 "conn": struct.pack("<I", conn_ids[topic]),
                 "time": struct.pack("<II", secs, nsecs)},
                payload,
            )
        )
    chunk = b"".join(parts)

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(
            record(
                {"op": bytes([OP_BAG_HEADER]),
                 "index_pos": struct.pack("<Q", 0),
                 "conn_count": struct.pack("<I", len(conn_ids)),
                 "chunk_count": struct.pack("<I", 1)},
                b" " * 4096,  # spec: header record padded to 4 KiB
            )
        )
        if compression == "bz2":
            payload = bz2.compress(chunk)
        elif compression == "lz4":
            from uslam_tpu_torch.io import lz4f

            payload = lz4f.compress(chunk)
        else:
            payload = chunk
        f.write(
            record(
                {"op": bytes([OP_CHUNK]),
                 "compression": compression.encode(),
                 "size": struct.pack("<I", len(chunk))},
                payload,
            )
        )
