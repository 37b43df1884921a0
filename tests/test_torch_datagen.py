"""Port parity for the warehouse layer: ``data/schemas.py`` and
``data/generators.py`` of ``ncf_tpu_torch`` against the JAX package's.

Both are NumPy/stdlib code drawing from the same seeds in the same
order, so every comparison is exact: the schema table, ``validate_row``'s
messages on good and bad rows, each generator's rows for two seeds, and
``build_warehouse``'s five JSONL files byte for byte with equal
``Interactions`` arrays.
"""

import os

import numpy as np
import pytest

from ncf_tpu.data import generators as jgen
from ncf_tpu.data import schemas as jschemas
from ncf_tpu.data.synthetic import generate_interactions as jgenerate
from ncf_tpu_torch.data import generators as tgen
from ncf_tpu_torch.data import schemas as tschemas
from ncf_tpu_torch.data.synthetic import generate_interactions as tgenerate

TABLES = ("loyalty_customer_dim", "store_dim", "product_features",
          "transaction_header_fact", "transaction_body_fact")


def test_schema_definitions_equal():
    assert tschemas.SCHEMA_DEFINITIONS == jschemas.SCHEMA_DEFINITIONS
    assert set(tschemas.SCHEMA_DEFINITIONS) == set(TABLES)
    assert len(tschemas.SCHEMA_DEFINITIONS["store_dim"]) >= 167


ROWS = [
    ("loyalty_customer_dim", {"cardnumber": "7001", "cust_code": "C1",
                              "enrollment_status": 1}),
    ("loyalty_customer_dim", {"cust_code": "C1"}),
    ("loyalty_customer_dim", {"cardnumber": 5, "cust_code": "C1",
                              "enrollment_status": 1}),
    ("loyalty_customer_dim", {"cardnumber": "7", "cust_code": "C1",
                              "enrollment_status": 1, "bogus": 1}),
    ("loyalty_customer_dim", {"cardnumber": "7", "cust_code": "C1",
                              "enrollment_status": True}),
    ("store_dim", {"location_id": "S1"}),
    ("product_features", {"product_id": "P1", "dietary_flags": "vegan"}),
    ("transaction_body_fact", {"quantity": 1.5, "unit_price": 2}),
    ("no_such_table", {}),
]


@pytest.mark.parametrize("table,row", ROWS)
def test_validate_row_gives_the_same_errors(table, row):
    assert tschemas.validate_row(table, row) == jschemas.validate_row(
        table, row)


@pytest.mark.parametrize("seed", [0, 11])
def test_customers_stores_and_products_equal(seed):
    assert tgen.generate_customers(60, seed) == jgen.generate_customers(
        60, seed)
    assert tgen.generate_stores(7, seed) == jgen.generate_stores(7, seed)
    t_rows, t_dept, t_cat = tgen.generate_products(50, seed)
    j_rows, j_dept, j_cat = jgen.generate_products(50, seed)
    assert t_rows == j_rows
    np.testing.assert_array_equal(t_dept, j_dept)
    np.testing.assert_array_equal(t_cat, j_cat)
    # unit_price keeps the catalog's float32 value, rounded in Python
    assert all(isinstance(r["unit_price"], float) for r in t_rows)


@pytest.mark.parametrize("seed", [0, 11])
def test_transactions_equal(seed):
    log = dict(num_users=40, num_items=25, num_days=20, avg_txns_per_user=5,
               seed=seed)
    assert (tgen.generate_transactions(tgenerate(**log), 6, seed)
            == jgen.generate_transactions(jgenerate(**log), 6, seed))


def test_build_warehouse_files_equal_byte_for_byte(tmp_path):
    size = dict(num_users=300, num_items=80, num_stores=8, num_days=30,
                seed=0)
    t_inter = tgen.build_warehouse(str(tmp_path / "port"), **size)
    j_inter = jgen.build_warehouse(str(tmp_path / "jax"), **size)
    for table in TABLES:
        with open(tmp_path / "port" / f"{table}.jsonl", "rb") as f:
            port = f.read()
        with open(tmp_path / "jax" / f"{table}.jsonl", "rb") as f:
            ref = f.read()
        assert port and port == ref, table
    for name in ("user_ids", "item_ids", "timestamps", "amounts",
                 "item_dept", "item_cat"):
        a, b = getattr(t_inter, name), getattr(j_inter, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("num_users", "num_items", "num_departments",
                 "num_categories", "user_map", "item_map"):
        assert getattr(t_inter, name) == getattr(j_inter, name), name
    writer = tschemas.DatasetWriter(str(tmp_path / "port"))
    assert writer.count_rows("loyalty_customer_dim") == 300
    assert writer.count_rows("transaction_body_fact") == len(t_inter)
    for table in TABLES:
        for row in writer.read_rows(table)[:50]:
            assert tschemas.validate_row(table, row) == []
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f"{t}.jsonl" for t in TABLES)
