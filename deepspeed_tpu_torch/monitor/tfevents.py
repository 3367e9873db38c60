"""Dependency-free TensorBoard event-file (tfevents) writer + reader.

`torch.utils.tensorboard.SummaryWriter` needs the tensorboard package;
the scalar-event subset of the format is tiny, so it is written
natively, byte for byte as the JAX package's writer writes it:

  * a tfevents file is a sequence of TFRecords:
      uint64 length | uint32 masked-crc32c(length) |
      data[length]  | uint32 masked-crc32c(data)
    with CRC32C (Castagnoli) masked the TensorFlow way
    (((crc >> 15) | (crc << 17)) + 0xa282ead8).
  * each record is a serialized `Event` proto; we hand-encode the three
    fields the scalar dashboard needs — wall_time (field 1, double),
    step (field 2, varint), and either file_version (field 3, string —
    the mandatory first record, "brain.Event:2") or summary (field 5)
    holding `Summary.Value{tag, simple_value}` messages.

`read_tfevents` is the inverse (with CRC verification) so tests and
tools can load the files without tensorboard or tensorflow installed.
"""

import os
import socket
import struct
import threading
import time

# ----------------------------------------------------------------------
# CRC32C (Castagnoli, reflected poly 0x82F63B78) — table-driven
# ----------------------------------------------------------------------
_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data, crc=0):
    table = _crc_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# minimal protobuf wire encoding (varint + the two wire types we emit)
# ----------------------------------------------------------------------
def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire_type):
    return _varint((field << 3) | wire_type)


def _len_delim(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def encode_scalar_event(wall_time, step, scalars):
    """Serialize one Event carrying `scalars` ({tag: float})."""
    summary = b"".join(
        _len_delim(1,                               # Summary.value
                   _len_delim(1, str(tag).encode("utf-8")) +   # tag
                   _key(2, 5) + struct.pack("<f", float(val)))  # simple_value
        for tag, val in scalars.items())
    return (_key(1, 1) + struct.pack("<d", float(wall_time)) +
            _key(2, 0) + _varint(max(0, int(step))) +
            _len_delim(5, summary))


def encode_file_version_event(wall_time):
    return (_key(1, 1) + struct.pack("<d", float(wall_time)) +
            _len_delim(3, b"brain.Event:2"))


def _record(data):
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) +
            data + struct.pack("<I", masked_crc32c(data)))


class TFEventsWriter:
    """Append scalar events to one `events.out.tfevents.*` file."""

    def __init__(self, log_dir, filename_suffix=""):
        os.makedirs(log_dir, exist_ok=True)
        try:
            host = socket.gethostname()
        except OSError:
            host = "localhost"
        self.path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(time.time())}.{host}"
            f".{os.getpid()}{filename_suffix}")
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._write(_record(encode_file_version_event(time.time())))

    def _write(self, blob):
        self._f.write(blob)

    def add_scalars(self, scalars, step, wall_time=None):
        """Write {tag: float} as one Event at `step`."""
        if not scalars:
            return
        wall_time = time.time() if wall_time is None else wall_time
        blob = _record(encode_scalar_event(wall_time, step, scalars))
        with self._lock:
            self._write(blob)

    def add_scalar(self, tag, value, step, wall_time=None):
        self.add_scalars({tag: value}, step, wall_time)

    def flush(self):
        """Make buffered records visible to a live TensorBoard reader
        (no fsync — durability is close()'s job; a per-fence fsync
        costs more than the fenced training window)."""
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                # ds-lint: allow[LOCKBLOCK] one fsync at close only; the lock orders it against concurrent add_scalars writers
                os.fsync(self._f.fileno())
                self._f.close()


class SummaryWriter:
    """Drop-in for the `torch.utils.tensorboard.SummaryWriter` subset
    the engine uses (`add_scalar`/`flush`/`close`), backed by the
    native tfevents writer — no torch, no tensorflow."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self._writer = TFEventsWriter(log_dir)

    def add_scalar(self, tag, scalar_value, global_step=None,
                   walltime=None):
        self._writer.add_scalar(tag, float(scalar_value),
                                0 if global_step is None else global_step,
                                wall_time=walltime)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


# ----------------------------------------------------------------------
# reader (tests / tooling; torch-free loading proof)
# ----------------------------------------------------------------------
def _read_varint(buf, pos):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _parse_fields(buf):
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def read_tfevents(path):
    """Parse a tfevents file into a list of event dicts
    ({wall_time, step, file_version?, scalars: {tag: value}}),
    verifying every record CRC."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != masked_crc32c(header):
            raise ValueError(f"corrupt record header at byte {pos}")
        body = data[pos + 12:pos + 12 + length]
        (bcrc,) = struct.unpack("<I",
                                data[pos + 12 + length:pos + 16 + length])
        if bcrc != masked_crc32c(body):
            raise ValueError(f"corrupt record body at byte {pos}")
        pos += 16 + length

        ev = {"wall_time": 0.0, "step": 0, "scalars": {}}
        for field, wt, val in _parse_fields(body):
            if field == 1 and wt == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif field == 2 and wt == 0:
                ev["step"] = val
            elif field == 3 and wt == 2:
                ev["file_version"] = val.decode("utf-8")
            elif field == 5 and wt == 2:
                for f2, wt2, v2 in _parse_fields(val):
                    if f2 == 1 and wt2 == 2:   # Summary.value
                        tag, sv = None, None
                        for f3, wt3, v3 in _parse_fields(v2):
                            if f3 == 1 and wt3 == 2:
                                tag = v3.decode("utf-8")
                            elif f3 == 2 and wt3 == 5:
                                sv = struct.unpack("<f", v3)[0]
                        if tag is not None and sv is not None:
                            ev["scalars"][tag] = sv
        events.append(ev)
    return events
