"""Boundaries of spark_rapids_tpu_torch: it imports neither jax nor the
JAX package, nor pyarrow or pandas (a GPU host need not have them; the
``io/`` package encodes Parquet itself), it never drops silently to the
CPU, its kernel wrappers take
the plain version only for CPU tensors, and nothing builds at import."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch
from spark_rapids_tpu_torch import Session, types as T
from spark_rapids_tpu_torch.data.column import (DeviceColumn, HostBatch,
                                                bucket_rows, device_to_host,
                                                host_to_device)
from spark_rapids_tpu_torch.interop import (from_reference_arrays,
                                            to_reference_arrays)
from spark_rapids_tpu_torch.ops.kernels import _build
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.ops.kernels import segment as S

ROOT = pathlib.Path(spark_rapids_tpu_torch.__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden_imports(path, tops=("jax", "jaxlib", "spark_rapids_tpu")):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            if top in tops:
                bad.append(name)
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    assert path.exists()
    assert _forbidden_imports(path) == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_pyarrow_or_pandas(path):
    assert _forbidden_imports(path, ("pyarrow", "pandas")) == []


def test_io_package_is_covered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"spark_rapids_tpu_torch/io/parquet.py",
            "spark_rapids_tpu_torch/io/writers.py",
            "spark_rapids_tpu_torch/io/scans.py",
            "spark_rapids_tpu_torch/exec/write.py"} <= names


def test_session_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session()


def test_session_on_cpu_only_when_asked():
    assert Session(device="cpu").device.type == "cpu"


def test_host_engine_conf_is_refused():
    sess = Session({"spark.rapids.tpu.sql.enabled": False}, device="cpu")
    df = sess.create_dataframe({"a": [1, 2]})
    with pytest.raises(NotImplementedError, match="host engine"):
        df.collect()


def test_wrappers_take_plain_version_on_cpu_without_counting():
    counters = [S.SORT_LAUNCHES, S.SEGMENT_IDS_LAUNCHES,
                S.SEGMENT_REDUCE_LAUNCHES, G.GATHER_LAUNCHES,
                G.COMPACT_LAUNCHES]
    before = [c.count for c in counters]
    sess = Session(device="cpu")
    df = sess.create_dataframe({"k": [2, 1, 2], "v": [1.0, 2.0, 3.0]})
    from spark_rapids_tpu_torch import f

    assert df.group_by("k").agg(f.sum("v").alias("s")).sort("k") \
        .collect() == [(1, 2.0), (2, 4.0)]
    assert [c.count for c in counters] == before
    assert _build.CUDA.libs == {}  # nothing was built or loaded


def test_distributed_runner_on_cpu_shards_counts_no_launch():
    from spark_rapids_tpu_torch import f
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    from spark_rapids_tpu_torch.parallel.runner import run_distributed
    from spark_rapids_tpu_torch.shuffle import device_shuffle as DS

    counters = [DS.BUILD_LAUNCHES, DS.TILE_LAUNCHES, G.COMPACT_LAUNCHES]
    before = [c.count for c in counters]
    sess = Session(device="cpu")
    df = sess.create_dataframe({"k": [2, 1, 2], "v": [1.0, 2.0, 3.0]})
    q = df.group_by("k").agg(f.sum("v").alias("s")).sort("k")
    assert run_distributed(sess, q, mesh=make_mesh(3, device="cpu")) \
        .to_rows() == [(1, 2.0), (2, 4.0)]
    assert [c.count for c in counters] == before
    assert _build.CUDA.libs == {}


def test_wrappers_refuse_other_devices():
    col = DeviceColumn(T.INT32, torch.zeros(4, dtype=torch.int32,
                                            device="meta"),
                       torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="device"):
        S.lexsort_device([col])


def test_kernel_sources_and_build_key():
    names = {p.name for p in _build.CSRC.iterdir()}
    for src, _fns in _build.KERNELS.values():
        assert src in names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build.source_hash()) == 16


def test_reference_arrays_round_trip():
    fields = [("s", "string"), ("d", "date"), ("x", "double")]
    arrays = [np.array(["ab", None, "", "héllo"], dtype=object),
              np.array([1, 2, 3, 4], dtype=np.int32),
              np.array([0.5, -0.0, np.nan, 2.0])]
    hb = from_reference_arrays(fields, arrays)
    assert hb.schema.dtypes == [T.STRING, T.DATE32, T.FLOAT64]
    assert hb.column("s").to_pylist() == ["ab", None, "", "héllo"]
    back_fields, back = to_reference_arrays(hb)
    assert back_fields == fields
    assert list(back["s"]) == ["ab", None, "", "héllo"]
    np.testing.assert_array_equal(back["d"], arrays[1])


def test_upload_download_round_trip_pads_to_bucket():
    hb = HostBatch.from_pydict({"s": ["x", None, "yz"], "v": [1, None, 3]})
    db = host_to_device(hb, 128, device="cpu")
    assert db.padded_rows == bucket_rows(3) == 128
    assert db.num_rows.dtype == torch.int32 and db.num_rows.dim() == 0
    assert not bool(db.columns[1].validity[3:].any())
    assert device_to_host(db).to_pydict() == hb.to_pydict()
