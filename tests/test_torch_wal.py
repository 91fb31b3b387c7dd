"""The port's write-ahead log (repro_torch.runtime.wal) against the JAX
package's (repro.runtime.wal): the four framing properties of
``tests/test_recovery.py`` (round trip, torn tail truncated on reopen, a
corrupt payload ends the valid prefix, ``truncate_through`` drops the
checkpointed prefix) on the port's log; the same records written by both
give the same bytes (ops of 2, 3 and 4 fields kept as given); and each
package reads the other's log, torn tail included."""
import os

import numpy as np
import pytest

from repro.runtime import wal as J
from repro_torch.runtime import wal as T

R_TRUE = 1


def _rec(M, epoch, ops, clients=("c0",), results=None):
    results = results if results is not None else [R_TRUE] * len(ops)
    return M.WalRecord(epoch=epoch, ops=[list(o) for o in ops], pad=len(ops),
                       clients=list(clients), batch_ids=[epoch - 1],
                       results=results, lanes=len(ops))


def test_wal_roundtrip(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = T.WriteAheadLog(path)
    recs = [_rec(T, e, [[1, e, 0, 0], [4, e, e + 1, 0]]) for e in (1, 2, 3)]
    for r in recs:
        wal.append(r)
    assert len(wal) == 3
    assert wal.stats.records == 3 and wal.stats.bytes == os.path.getsize(path)
    wal.close()
    back = list(T.WriteAheadLog(path).records())
    assert [r.epoch for r in back] == [1, 2, 3]
    for a, b in zip(back, recs):
        assert a.ops == b.ops and a.results == b.results
        assert a.clients == b.clients and a.pad == b.pad


def test_wal_torn_tail_truncated_on_reopen(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = T.WriteAheadLog(path)
    wal.append(_rec(T, 1, [[1, 5, 0, 0]]))
    wal.append_torn(_rec(T, 2, [[1, 6, 0, 0]]))     # the wal-append window
    size_torn = os.path.getsize(path)
    wal.close()
    wal2 = T.WriteAheadLog(path)                    # reopen scans + truncates
    assert [r.epoch for r in wal2.records()] == [1]
    assert wal2.stats.torn_drops == size_torn - os.path.getsize(path) > 0
    wal2.append(_rec(T, 2, [[1, 6, 0, 0]]))       # appends at the cut point
    assert [r.epoch for r in wal2.records()] == [1, 2]


def test_wal_corrupt_payload_truncates_from_there(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = T.WriteAheadLog(path)
    for e in (1, 2, 3):
        wal.append(_rec(T, e, [[1, e, 0, 0]]))
    wal.close()
    # flip one byte inside record 2's payload: the crc rejects it and
    # everything after it
    data = bytearray(open(path, "rb").read())
    first_len = len(wal._frame(_rec(T, 1, [[1, 1, 0, 0]]).to_payload()))
    data[first_len + 20] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert [r.epoch for r in T.WriteAheadLog(path).records()] == [1]


def test_wal_truncate_through_drops_checkpointed_prefix(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = T.WriteAheadLog(path)
    for e in range(1, 6):
        wal.append(_rec(T, e, [[1, e, 0, 0]]))
    assert wal.truncate_through(3) == 2
    assert [r.epoch for r in wal.records()] == [4, 5]
    assert wal.stats.truncations == 1
    assert not os.path.exists(path + ".tmp")        # renamed over the log
    wal.append(_rec(T, 6, [[1, 6, 0, 0]]))
    assert [r.epoch for r in wal.records()] == [4, 5, 6]


def _records(M, rng):
    """Records with ops of every length a client may give, negative keys,
    CAS expectations and several clients, from a numpy seed."""
    out = []
    for e in range(1, 7):
        ops = []
        for _ in range(int(rng.integers(1, 6))):
            n = int(rng.integers(2, 5))
            ops.append([int(x) for x in rng.integers(-2, 300, n)])
        clients = [f"c{int(c)}" for c in rng.integers(0, 4, 2)]
        out.append(M.WalRecord(
            epoch=e, ops=ops, pad=8, clients=clients,
            batch_ids=[int(x) for x in rng.integers(0, 99, 2)],
            results=[int(x) for x in rng.integers(0, 9, len(ops))],
            lanes=len(ops)))
    return out


def _write(M, path, records, torn=None):
    wal = M.WriteAheadLog(path)
    for r in records:
        wal.append(r)
    if torn is not None:
        wal.append_torn(torn)
    wal.close()
    return open(path, "rb").read()


def test_the_same_records_give_the_same_bytes_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    jrecs, trecs = _records(J, rng), _records(T, np.random.default_rng(0))
    jb = _write(J, str(tmp_path / "j.log"), jrecs)
    tb = _write(T, str(tmp_path / "t.log"), trecs)
    assert tb == jb
    assert [r.to_payload() for r in trecs] == [r.to_payload() for r in jrecs]
    assert {len(op) for r in trecs for op in r.ops} == {2, 3, 4}


def test_a_numpy_scalar_in_a_record_raises():
    rec = T.WalRecord(epoch=1, ops=[[1, np.int32(5)]], pad=8)
    with pytest.raises(TypeError):
        rec.to_payload()


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)],
                         ids=["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_log(tmp_path, writer, reader):
    path = str(tmp_path / "wal.log")
    recs = _records(writer, np.random.default_rng(1))
    torn = _rec(writer, 7, [[1, 7, 0, 0]])
    _write(writer, path, recs, torn=torn)
    wal = reader.WriteAheadLog(path)
    assert wal.stats.torn_drops > 0 and len(wal) == len(recs)
    back = list(wal.records())
    assert [r.to_payload() for r in back] == [r.to_payload() for r in recs]
    wal.close()
