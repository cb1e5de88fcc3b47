"""The packed upload of spark_rapids_tpu_torch (``data/column.py``:
``_upload_arrays``, ``_pack_host``, ``_unpack``) on the CPU.

* The layout (offsets, shapes, dtypes) and the bytes of the packed host
  buffer equal the reference's ``_pack_host`` of the arrays its
  ``host_to_device`` uploads, for a batch of every column type with
  nulls (tinyint to double, boolean, date, timestamp, strings with empty
  rows and multi-byte characters), at 300 rows (padded to 512) and at
  one row (padded to the 128-row minimum).  The port appends the row
  count as one int32 after the reference's arrays.
* The views decoded from that one buffer equal the per-array upload of
  ``host_to_device(batch, device="cpu")``, bit for bit (data with its
  invalid lanes zeroed, validity, lengths, the row count)."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data import column as JC
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data import column as PC

TYPES = ["tinyint", "smallint", "int", "bigint", "float", "double",
         "boolean", "date", "timestamp", "string"]


def _values(name, n, rng):
    if name == "string":
        words = ["", "a", "héllo", "wörld!", "x" * 17]
        vals = [words[i] for i in rng.integers(0, len(words), n)]
    elif name in ("float", "double"):
        vals = [float(v) for v in rng.choice([0.0, -0.0, 1.5, -2.25, 3e7],
                                             n)]
    elif name == "boolean":
        vals = [bool(v) for v in rng.random(n) > 0.5]
    else:
        vals = [int(v) for v in rng.integers(-100, 100, n)]
    return [None if rng.random() < 0.25 else v for v in vals]


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    data = {f"c_{t}": _values(t, n, rng) for t in TYPES}
    jschema = JT.Schema([JT.Field(f"c_{t}", JT.from_name(t)) for t in TYPES])
    pschema = PT.Schema([PT.Field(f"c_{t}", PT.from_name(t)) for t in TYPES])
    return (JC.HostBatch.from_pydict(data, jschema),
            PC.HostBatch.from_pydict(data, pschema))


def _reference_pack(monkeypatch, jb):
    """The reference's packed buffer and layout for ``jb``'s upload."""
    seen = []
    real = JC.packed_upload

    def capture(arrays, device=None):
        seen.append(JC._pack_host(arrays))
        return real(arrays, device)

    monkeypatch.setattr(JC, "_packing_ok", lambda: True)
    monkeypatch.setattr(JC, "packed_upload", capture)
    JC.host_to_device(jb)
    (packed,) = seen
    return packed


@pytest.mark.parametrize("n", [300, 1])
def test_layout_and_bytes_match_reference(monkeypatch, n):
    jb, pb = _batches(n, seed=n)
    want_buf, want_layout = _reference_pack(monkeypatch, jb)
    padded = PC.bucket_rows(n)
    arrays = PC._upload_arrays(pb, padded)
    buf, layout = PC._pack_host(
        arrays + [(np.asarray(n, dtype=np.int32), (), None)])
    assert layout[:-1] == want_layout
    assert layout[-1][1:] == ((), "<i4")
    assert layout[-1][0] == (len(want_buf) + 7) & ~7
    np.testing.assert_array_equal(buf.numpy()[:len(want_buf)], want_buf)
    assert PC._pack_host(arrays)[1] == want_layout


@pytest.mark.parametrize("n", [300, 1])
def test_views_equal_per_array_upload(n):
    _jb, pb = _batches(n, seed=n + 1)
    padded = PC.bucket_rows(n)
    buf, layout = PC._pack_host(
        PC._upload_arrays(pb, padded)
        + [(np.asarray(n, dtype=np.int32), (), None)])
    views = PC._unpack(buf, layout)
    want = PC.host_to_device(pb, device="cpu")
    flat = [t for c in want.columns
            for t in (c.data, c.validity, c.lengths) if t is not None]
    assert len(views) == len(flat) + 1
    for v, w in zip(views, flat):
        assert v.dtype == w.dtype and v.shape == w.shape
        assert torch.equal(v.contiguous().view(torch.uint8),
                           w.contiguous().view(torch.uint8))
    assert views[-1].shape == () and int(views[-1]) == int(want.num_rows)
