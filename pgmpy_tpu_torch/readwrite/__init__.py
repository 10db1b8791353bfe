"""Readers and writers of the network file formats.

Every format is imported plainly (the JAX package registers each inside
``try/except ImportError``, which would hide a broken module behind "Unknown
file format"); ``get_reader`` / ``get_writer`` map a format name to its
class.
"""

from pgmpy_tpu_torch.readwrite.bif import BIFReader, BIFWriter
from pgmpy_tpu_torch.readwrite.net import NETReader, NETWriter
from pgmpy_tpu_torch.readwrite.pomdpx import PomdpXReader, PomdpXWriter
from pgmpy_tpu_torch.readwrite.uai import UAIReader, UAIWriter
from pgmpy_tpu_torch.readwrite.xbn import XBNReader, XBNWriter
from pgmpy_tpu_torch.readwrite.xdsl import XDSLReader, XDSLWriter
from pgmpy_tpu_torch.readwrite.xmlbif import XMLBIFReader, XMLBIFWriter

_READERS = {
    "bif": BIFReader,
    "xmlbif": XMLBIFReader,
    "net": NETReader,
    "uai": UAIReader,
    "xdsl": XDSLReader,
    "xbn": XBNReader,
    "pomdpx": PomdpXReader,
}
_WRITERS = {
    "bif": BIFWriter,
    "xmlbif": XMLBIFWriter,
    "net": NETWriter,
    "uai": UAIWriter,
    "xdsl": XDSLWriter,
    "xbn": XBNWriter,
    "pomdpx": PomdpXWriter,
}

__all__ = [cls.__name__ for registry in (_READERS, _WRITERS) for cls in registry.values()] + [
    "get_reader",
    "get_writer",
]


def get_reader(filetype):
    try:
        return _READERS[filetype.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown file format: {filetype}. Supported: {sorted(_READERS)}"
        )


def get_writer(filetype):
    try:
        return _WRITERS[filetype.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown file format: {filetype}. Supported: {sorted(_WRITERS)}"
        )


def filetype_of(filename):
    """The format named by ``filename``'s extension, looking past a final
    ``.gz``."""
    parts = str(filename).rsplit(".", 2)
    if parts[-1].lower() == "gz" and len(parts) > 2:
        return parts[-2].lower()
    return parts[-1].lower()
