"""Wire framing for the HTTP transport: ``Payload`` ↔ bytes.

The port's copy of ``repro/fedsrv/wire.py``; a frame is byte-identical to
the reference's for the same payload:

    ``b"FDX1"`` · u32 header length (big-endian) · JSON header · raw buffers

The JSON header (separators ``","`` and ``":"``) carries the payload's
identity (round / client / direction / codec, and ``rank`` for a ragged
uplink) and one descriptor per tensor ``{path, dtype, shape, declared,
scale, nbytes}`` in buffer order; the tensors' bytes follow back to back in
that order. ``declared`` carries :attr:`EncodedTensor.shape`, so a truncated
buffer still declares its full shape and the codec's decode quarantines it.
An int8 ``scale`` (a 0-dim float64 tensor in the port) is written as the
Python float it holds, the reference's JSON text.

The port's payloads live on the device: :func:`payload_to_wire` copies
each tensor to the host, and :func:`payload_from_wire` builds host tensors
over the frame (``torch.frombuffer`` on a ``bytearray``, no copy) and moves
them to ``device``. Every malformation — bad magic, a truncated header or
body, an unknown dtype, a length that disagrees with its descriptor,
trailing bytes — raises :class:`TransportError` with ``reason="wire"``.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Any, Dict, Union

import torch

from repro_torch.fedsrv.transport import (EncodedTensor, Payload,
                                          TransportError)

MAGIC = b"FDX1"
_HDR = struct.Struct(">I")          # u32 big-endian JSON header length
# the wire dtypes, one per codec tier (none / fp16 / int8)
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}

#: fixed framing overhead per payload, before the JSON header
FRAME_OVERHEAD = len(MAGIC) + _HDR.size


def _wire_error(msg: str, round_id=None, client_id=None) -> TransportError:
    return TransportError(msg, round_id=round_id, client_id=client_id,
                          reason="wire")


def payload_to_wire(payload: Payload) -> bytes:
    """Serialize a payload to one self-describing frame (each tensor copied
    to the host)."""
    descs, chunks = [], []
    for path, enc in payload.tensors.items():
        arr = enc.data.detach().contiguous().cpu()
        descs.append({
            "path": path,
            "dtype": _NAMES[arr.dtype],
            "shape": list(arr.shape),
            "declared": None if enc.shape is None else list(enc.shape),
            "scale": None if enc.scale is None else float(enc.scale),
            "nbytes": arr.numel() * arr.element_size(),
        })
        chunks.append(arr.numpy().tobytes())
    hdr: Dict[str, Any] = {
        "round_id": payload.round_id,
        "client_id": payload.client_id,
        "direction": payload.direction,
        "codec": payload.codec,
        "tensors": descs,
    }
    if payload.rank is not None:
        # a ragged (hetero) uplink declares its rank; a uniform frame has
        # no such key
        hdr["rank"] = int(payload.rank)
    header = json.dumps(hdr, separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, _HDR.pack(len(header)), header] + chunks)


def payload_from_wire(data: Union[bytes, bytearray],
                      device="cpu") -> Payload:
    """Parse one frame back into a :class:`Payload` whose tensors lie on
    ``device`` (defended: see the module docstring). A ``bytearray`` frame
    is viewed in place; ``bytes`` are copied into one first."""
    if len(data) < FRAME_OVERHEAD or bytes(data[:len(MAGIC)]) != MAGIC:
        raise _wire_error(f"bad magic / truncated frame ({len(data)} B)")
    (hlen,) = _HDR.unpack_from(data, len(MAGIC))
    body_at = FRAME_OVERHEAD + hlen
    if len(data) < body_at:
        raise _wire_error(f"truncated header: declares {hlen} B, "
                          f"frame has {len(data) - FRAME_OVERHEAD}")
    try:
        header: Dict[str, Any] = json.loads(
            bytes(data[FRAME_OVERHEAD:body_at]).decode("utf-8"))
        round_id = int(header["round_id"])
        client_id = int(header["client_id"])
        direction = str(header["direction"])
        codec = str(header["codec"])
        rank = header.get("rank")
        rank = None if rank is None else int(rank)
        descs = header["tensors"]
        if not isinstance(descs, list):
            raise TypeError("tensors is not a list")
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise _wire_error(f"malformed JSON header: {e}") from e

    buf = data if isinstance(data, bytearray) else bytearray(data)
    tensors: Dict[str, EncodedTensor] = {}
    off = body_at
    for d in descs:
        try:
            path = str(d["path"])
            dtype = _DTYPES[d["dtype"]]
            shape = tuple(int(s) for s in d["shape"])
            declared = d.get("declared")
            declared = (None if declared is None
                        else tuple(int(s) for s in declared))
            scale = d.get("scale")
            scale = None if scale is None else float(scale)
            nbytes = int(d["nbytes"])
        except (ValueError, KeyError, TypeError) as e:
            raise _wire_error(f"malformed tensor descriptor: {e}",
                              round_id, client_id) from e
        count = math.prod(shape)
        want = count * dtype.itemsize
        if nbytes != want:
            raise _wire_error(
                f"{path}: descriptor nbytes={nbytes} disagrees with "
                f"dtype/shape ({want} B)", round_id, client_id)
        if off + nbytes > len(buf):
            raise _wire_error(
                f"{path}: truncated body (need {nbytes} B at offset {off}, "
                f"frame is {len(buf)} B)", round_id, client_id)
        if count:
            host = torch.frombuffer(buf, dtype=dtype, count=count,
                                    offset=off)
        else:
            host = torch.empty(0, dtype=dtype)
        off += nbytes
        tensors[path] = EncodedTensor(
            host.reshape(shape).to(device),
            None if scale is None else torch.tensor(
                scale, dtype=torch.float64, device=device),
            declared)
    if off != len(buf):
        raise _wire_error(f"trailing garbage: {len(buf) - off} B past the "
                          "last tensor", round_id, client_id)
    return Payload(round_id=round_id, client_id=client_id,
                   direction=direction, codec=codec, tensors=tensors,
                   rank=rank)
