"""SQLite pickle-blob KV store.

Behavioral mirror of the reference persistence layer (utils/db.py): WAL-mode
SQLite, one table per logical namespace with composite (id, key) primary key,
pickled values, versioned table names, and "dict folding" on full-table reads
(multi-id rows fold into {id: val}; a lone id=='1' row unwraps to the bare
value). The HTTP threads and the NVR loop communicate through this store.

Re-design: per-thread connections (the reference shares one connection across
threads with check_same_thread=False; WAL tolerates it but per-thread
connections remove the lock contention its busy_timeout papers over). Each
put is one write transaction, so concurrent puts on one key serialize.
"""
from __future__ import annotations

import pickle
import sqlite3
import threading
from pathlib import Path
from typing import Any

VERSION = 1


class KVStore:
    def __init__(self, path: str | Path = "data/cc_cache.db"):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._local = threading.local()
        self._tables: set[str] = set()
        self._tables_lock = threading.Lock()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=60, isolation_level=None)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=60000")
            self._local.conn = conn
        return conn

    def _table(self, name: str) -> str:
        tname = f"{name}_{VERSION}"
        if name not in self._tables:
            with self._tables_lock:
                self._conn().execute(
                    f"CREATE TABLE IF NOT EXISTS '{tname}' "
                    "(id TEXT, key TEXT, val BLOB, PRIMARY KEY (id, key))")
                self._tables.add(name)
        return tname

    # -- API (same verbs as reference db class, db.py:107-111) -------------

    def run_put(self, table: str, key: str, val: Any = None,
                id: str | int | None = None, replace: bool = True):
        """One transaction (``BEGIN IMMEDIATE``: the write lock first), so
        two threads putting one key never interleave a DELETE or a next-id
        read with the other's INSERT."""
        t = self._table(table)
        conn = self._conn()
        key = str(key)
        conn.execute("BEGIN IMMEDIATE")
        try:
            if replace:
                if id is None:
                    conn.execute(f"DELETE FROM '{t}' WHERE key=?", (key,))
                    id = "1"
                else:
                    conn.execute(f"DELETE FROM '{t}' WHERE id=? AND key=?", (str(id), key))
            elif id is None:
                row = conn.execute(
                    f"SELECT COALESCE(MAX(CAST(id AS INTEGER)), 0) + 1 FROM '{t}' WHERE key=?",
                    (key,)).fetchone()
                id = str(row[0]) if row and row[0] else "1"
            conn.execute(f"INSERT INTO '{t}' (id, key, val) VALUES (?,?,?)",
                         (str(id), key, pickle.dumps(val)))
        except BaseException:
            conn.execute("ROLLBACK")
            raise
        conn.execute("COMMIT")
        return val, str(id)

    def run_get(self, table: str, key: str | None = None,
                id: str | int | None = None) -> Any:
        t = f"{table}_{VERSION}"
        conn = self._conn()
        try:
            if key is None:
                rows = conn.execute(f"SELECT id, key, val FROM '{t}'").fetchall()
            elif id is not None:
                row = conn.execute(f"SELECT val FROM '{t}' WHERE key=? AND id=?",
                                   (str(key), str(id))).fetchone()
                return pickle.loads(row[0]) if row else None
            else:
                rows = [(rid, key, val) for rid, val in conn.execute(
                    f"SELECT id, val FROM '{t}' WHERE key=?", (str(key),)).fetchall()]
        except sqlite3.OperationalError:
            return {}

        if key is not None:
            if not rows:
                return {}
            if len(rows) == 1 and rows[0][0] == "1":
                return pickle.loads(rows[0][2])
            return {rid: pickle.loads(val) for rid, _, val in rows}

        # full-table read with dict folding
        out: dict[str, Any] = {}
        for rid, k, blob in rows:
            val = pickle.loads(blob)
            if val is None:
                continue
            if k not in out:
                out[k] = {rid: val} if rid != "1" else val
            elif isinstance(out[k], dict):
                out[k][rid] = val
            else:
                out[k] = {"1": out[k], rid: val}
        for k in list(out):
            if isinstance(out[k], dict) and len(out[k]) == 1 and "1" in out[k]:
                out[k] = out[k]["1"]
        return out

    def run_delete(self, table: str, key: str, id: str | int | None = None) -> bool:
        t = f"{table}_{VERSION}"
        conn = self._conn()
        try:
            if id is None:
                conn.execute(f"DELETE FROM '{t}' WHERE key=?", (str(key),))
            else:
                conn.execute(f"DELETE FROM '{t}' WHERE id=? AND key=?",
                             (str(id), str(key)))
            return True
        except sqlite3.OperationalError:
            return False
