"""Sessions and the local catalogs in the port (``daft_tpu_torch/session.py``,
``catalog.py``) against the JAX package's, on the CPU.

Mirrors ``tests/test_sql.py::test_session_tables`` and
``test_private_session_tables``; then the in-memory catalog
(``Catalog.from_pydict``, ``MemoryTable``) and the directory catalog over a
local warehouse of parquet tables, each read back with the JAX package's
rows (exact), a catalog write invalidating the cached reads under its path,
``register_table``, and the left-out catalogs raising with their ROADMAP
item.
"""

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import plancache
from daft_tpu_torch.errors import DaftNotImplementedError

PEOPLE = {"name": ["ann", "bob", "cat", "dan"], "age": [25, 32, 19, 45]}
PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu():
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        yield


def _sorted(d, key):
    order = sorted(range(len(d[key])), key=lambda i: d[key][i])
    return {k: [v[i] for i in order] for k, v in d.items()}


def test_session_tables():
    outs = []
    for pkg in PKGS:
        people = pkg.from_pydict(PEOPLE)
        s = pkg.current_session()
        s.create_temp_table("people_tmp", people)
        try:
            n = s.sql("SELECT count(*) AS n FROM people_tmp").to_pydict()
            s.create_table("people_mem", people)
            rows = s.get_table("people_mem").read().count_rows()
            assert "people_mem" in s.list_tables()
            # An unbound name in a plain sql() call resolves to the current
            # session's tables.
            via_sql = pkg.sql("SELECT name FROM people_mem WHERE age > 30").to_pydict()
            outs.append((n, rows, _sorted(via_sql, "name")))
        finally:
            s.detach_table("people_tmp")
            s.drop_table("people_mem")
        assert "people_mem" not in s.list_tables()
    assert outs[0] == outs[1] == ({"n": [4]}, 4, {"name": ["bob", "dan"]})


def test_private_session_tables():
    outs = []
    for pkg in PKGS:
        s = pkg.Session()
        s.create_temp_table("mine", pkg.from_pydict(PEOPLE))
        outs.append(s.sql("SELECT count(*) AS n FROM mine").to_pydict())
        # A private session's tables are its own.
        assert pkg.current_session().get_table("mine") is None
    assert outs[0] == outs[1] == {"n": [4]}


@pytest.mark.parametrize("source", ["frame", "dict", "schema"])
def test_in_memory_catalog_from_pydict(source):
    outs = []
    for pkg in PKGS:
        from importlib import import_module

        catalog = import_module(f"{pkg.__name__}.catalog")
        df = pkg.from_pydict(PEOPLE)
        obj = {"frame": df, "dict": PEOPLE, "schema": df.schema}[source]
        cat = pkg.Catalog.from_pydict({"people": obj}, name="mem")
        assert isinstance(cat, catalog.InMemoryCatalog)
        table = cat.get_table("people")
        if source == "schema":
            table.append(df)
        table.append(pkg.from_pydict({"name": ["eve"], "age": [51]}))
        s = pkg.Session()
        s.attach(cat)
        s.use("mem")
        rows = s.sql("SELECT name, age FROM people WHERE age > 20").to_pydict()
        outs.append((cat.list_tables(), cat.list_tables("peo*"), _sorted(rows, "name"),
                     sorted(s.list_catalogs())))
    assert outs[0] == outs[1]
    assert outs[1][2]["name"] == ["ann", "bob", "dan", "eve"]


def test_memory_table_overwrite_and_schema():
    outs = []
    for pkg in PKGS:
        from importlib import import_module

        catalog = import_module(f"{pkg.__name__}.catalog")
        t = catalog.MemoryTable("m", pkg.from_pydict(PEOPLE))
        t.overwrite(pkg.from_pydict({"name": ["x"], "age": [1]}))
        empty = catalog.MemoryTable("e", schema=t.schema())
        outs.append((t.read().to_pydict(), t.schema().column_names(),
                     empty.read().to_pydict()))
        with pytest.raises(pkg.DaftError if hasattr(pkg, "DaftError") else Exception):
            catalog.MemoryTable("none").read()
    assert outs[0] == outs[1]


def _warehouse(pkg, root):
    for name, data in (("people", PEOPLE), ("nums", {"x": list(range(10))})):
        pkg.from_pydict(data).write_parquet(str(root / name))
    (root / "not_a_table").mkdir()


def test_directory_catalog_reads_the_jax_package_rows(tmp_path):
    outs = []
    for pkg in PKGS:
        from importlib import import_module

        catalog = import_module(f"{pkg.__name__}.catalog")
        root = tmp_path / pkg.__name__
        root.mkdir()
        _warehouse(pkg, root)
        cat = catalog.DirectoryCatalog(str(root))
        s = pkg.Session()
        s.attach(cat)
        q = s.sql("SELECT p.name, p.age FROM warehouse.people AS p WHERE p.age < 40")
        outs.append((cat.list_tables(), cat.has_table("nope"),
                     _sorted(q.to_pydict(), "name"),
                     cat.get_table("nums").read().to_pydict()))
    assert outs[0] == outs[1]
    assert outs[1][0] == ["nums", "people"]


def test_directory_catalog_write_invalidates_cached_reads(tmp_path):
    from daft_tpu_torch.catalog import DirectoryCatalog

    plancache.reset_caches()
    cat = DirectoryCatalog(str(tmp_path))
    t = cat.create_table("events", daft_tpu_torch.from_pydict({"v": [1.0, 2.0]}))

    def total():
        return t.read().agg(daft_tpu_torch.col("v").sum().alias("s")).to_pydict()["s"][0]

    assert total() == total() == 3.0  # the second a result-cache hit
    assert plancache.get_result_cache().stats()["entries"] >= 1
    t.append(daft_tpu_torch.from_pydict({"v": [10.0]}))
    assert total() == 13.0
    t.overwrite(daft_tpu_torch.from_pydict({"v": [5.0]}))
    assert total() == 5.0
    cat.drop_table("events")
    assert not cat.has_table("events")
    plancache.reset_caches()


def test_register_table():
    from daft_tpu_torch.query_service import get_table_registry

    df = daft_tpu_torch.from_pydict(PEOPLE)
    daft_tpu_torch.register_table("people_svc", df)
    try:
        assert get_table_registry().tables()["people_svc"] is df
        assert "people_svc" in get_table_registry().names()
    finally:
        get_table_registry().unregister("people_svc")
    with pytest.raises(daft_tpu_torch.errors.DaftValueError):
        daft_tpu_torch.register_table("", df)


@pytest.mark.parametrize("kind", ["iceberg", "glue", "unity", "s3tables", "gravitino"])
def test_cloud_catalogs_raise_naming_their_item(kind):
    with pytest.raises(DaftNotImplementedError, match=r"A\.8\.3"):
        getattr(daft_tpu_torch.Catalog, f"from_{kind}")("x")


@pytest.mark.parametrize("marker, fmt", [("_delta_log", "delta"), (".hoodie", "hudi")])
def test_table_format_directories_raise_naming_their_item(tmp_path, marker, fmt):
    from daft_tpu_torch.catalog import DirectoryCatalog

    (tmp_path / "t" / marker).mkdir(parents=True)
    cat = DirectoryCatalog(str(tmp_path))
    assert cat.list_tables() == ["t"]
    with pytest.raises(DaftNotImplementedError, match=rf"{fmt} table.*A\.8\.3"):
        cat.get_table("t")


def test_load_extension_raises_naming_its_item():
    with pytest.raises(DaftNotImplementedError, match=r"A\.8\.7"):
        daft_tpu_torch.Session().load_extension("/nonexistent.so")


def test_use_unknown_catalog_raises_as_in_the_jax_package():
    msgs = []
    for pkg in PKGS:
        with pytest.raises(pkg.DaftError if hasattr(pkg, "DaftError") else Exception) as e:
            pkg.Session().use("nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
