"""Dataset schema definitions + schema-validating dataset writer.

The port's copy of ``ncf_tpu/data/schemas.py`` (stdlib only; the port
imports nothing of the JAX package), so both packages write the same
bytes.

Analogue of the reference's warehouse layer (reference:
src/data/schemas.py:4-414 — BigQuery schemas for 5 tables with
clustering/partitioning specs — and src/data/bigquery/data_loader.py:6-322
— batched row loaders, TRUNCATE, query execution).  There is no warehouse
in this stack: datasets are local JSONL/Parquet files; the schemas keep
the same table/column contracts so reference-side data can round-trip,
and the writer validates rows against them.

Column spec: (name, type, mode) with type in {STRING, INT64, FLOAT64,
BOOL, TIMESTAMP} and mode in {REQUIRED, NULLABLE, REPEATED}.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

Column = Tuple[str, str, str]

# Contracts of the reference's 5 warehouse tables (schemas.py:4-414).
# store_dim carries the reference's FULL 167-column profile (round 5 —
# reference store exports round-trip losslessly) prefixed by this
# framework's condensed core; the other tables keep condensed contracts
# (their extra reference columns are denormalized copies the
# recommendation path never reads).
SCHEMA_DEFINITIONS: Dict[str, List[Column]] = {
    "loyalty_customer_dim": [
        ("cardnumber", "STRING", "REQUIRED"),
        ("cust_code", "STRING", "REQUIRED"),
        ("first_name", "STRING", "NULLABLE"),
        ("last_name", "STRING", "NULLABLE"),
        ("email", "STRING", "NULLABLE"),
        ("state", "STRING", "NULLABLE"),
        ("zip", "STRING", "NULLABLE"),
        ("enrollment_status", "INT64", "REQUIRED"),
        ("activation_date", "TIMESTAMP", "NULLABLE"),
        ("first_transaction_date", "TIMESTAMP", "NULLABLE"),
        ("last_transaction_date", "TIMESTAMP", "NULLABLE"),
        ("lifetime_points", "FLOAT64", "NULLABLE"),
        ("first_transaction_location_id", "STRING", "NULLABLE"),
    ],
    # Full-breadth store profile: the reference's 167-column store_dim
    # contract (store_generator.py:8-668 / schemas.py store_dim section)
    # so reference-side store exports round-trip losslessly, plus this
    # framework's condensed core columns (location_id..amenities) that
    # the earlier rounds shipped.  Column families: identity/location,
    # access geometry, fuel/EV, food service, retail services, staffing/
    # systems, management, lifecycle dates.  DATE columns carry ISO
    # "YYYY-MM-DD" strings (the BigQuery DATE JSON form).
    "store_dim": [
        ("location_id", "STRING", "REQUIRED"),
        ("store_type", "STRING", "REQUIRED"),
        ("state", "STRING", "REQUIRED"),
        ("latitude", "FLOAT64", "NULLABLE"),
        ("longitude", "FLOAT64", "NULLABLE"),
        ("location_profile", "STRING", "NULLABLE"),
        ("open_date", "TIMESTAMP", "NULLABLE"),
        ("amenities", "STRING", "REPEATED"),
        ("store_number", "INT64", "REQUIRED"),
        ("store_number_label", "STRING", "NULLABLE"),
        ("ATM", "STRING", "NULLABLE"),
        ("Access_Points", "INT64", "NULLABLE"),
        ("Alcohol_Type", "STRING", "NULLABLE"),
        ("Allow_Pct_Shrink_Grocery", "FLOAT64", "NULLABLE"),
        ("At_Divided_Highway", "BOOL", "NULLABLE"),
        ("Auto_Diesel_Dispenser_Cnt", "INT64", "NULLABLE"),
        ("BMS_Status", "STRING", "NULLABLE"),
        ("Beer_Wine", "BOOL", "NULLABLE"),
        ("Big_6_Ice_Cream", "STRING", "NULLABLE"),
        ("Bitcoin_Kiosk", "STRING", "NULLABLE"),
        ("Board_Market", "STRING", "NULLABLE"),
        ("Brand_Refresh", "DATE", "NULLABLE"),
        ("Building_Type", "STRING", "NULLABLE"),
        ("Bulk_DEF", "BOOL", "NULLABLE"),
        ("Car_Wash_Brand", "BOOL", "NULLABLE"),
        ("Car_Wash_Region", "STRING", "NULLABLE"),
        ("Car_Wash_Type", "BOOL", "NULLABLE"),
        ("Carwash_ICS_Site_ID", "INT64", "NULLABLE"),
        ("Cig_Market", "STRING", "NULLABLE"),
        ("City", "STRING", "NULLABLE"),
        ("Close_Date", "DATE", "NULLABLE"),
        ("Coffee_Brewers", "STRING", "NULLABLE"),
        ("Coke_Freestyle", "BOOL", "NULLABLE"),
        ("Community", "BOOL", "NULLABLE"),
        ("Construction_Maintenance", "STRING", "NULLABLE"),
        ("Corner_Location", "BOOL", "NULLABLE"),
        ("County", "STRING", "NULLABLE"),
        ("Crypto_Currency_Acceptance", "STRING", "NULLABLE"),
        ("Curbside", "BOOL", "NULLABLE"),
        ("DMA", "STRING", "NULLABLE"),
        ("Delivery", "BOOL", "NULLABLE"),
        ("Diesel", "BOOL", "NULLABLE"),
        ("Diesel_Pumps", "INT64", "NULLABLE"),
        ("District_Manager", "STRING", "NULLABLE"),
        ("District_Manager_Employee_ID", "INT64", "NULLABLE"),
        ("District_Number", "STRING", "NULLABLE"),
        ("Divided_Side_Road", "BOOL", "NULLABLE"),
        ("Door_Dash", "BOOL", "NULLABLE"),
        ("Drive_Thru", "BOOL", "NULLABLE"),
        ("Drive_Thru_POS_Number", "INT64", "NULLABLE"),
        ("E0_Gas", "BOOL", "NULLABLE"),
        ("E15_Gas", "BOOL", "NULLABLE"),
        ("E85_Gas", "BOOL", "NULLABLE"),
        ("EV_Charger_Plug_Type", "STRING", "NULLABLE"),
        ("EV_PARKING_TOTAL_STALLS", "INT64", "NULLABLE"),
        ("EV_PLUGTYPE_CCS", "BOOL", "NULLABLE"),
        ("EV_PLUGTYPE_CHADEMO", "BOOL", "NULLABLE"),
        ("EV_PLUGTYPE_J1772", "BOOL", "NULLABLE"),
        ("EV_PLUGTYPE_NACS", "BOOL", "NULLABLE"),
        ("EV_POWER_MAX", "FLOAT64", "NULLABLE"),
        ("Electric_Vehicle_Charger", "BOOL", "NULLABLE"),
        ("Espresso_Machine", "STRING", "NULLABLE"),
        ("FEIN", "STRING", "NULLABLE"),
        ("Fax_Telephone_Number", "STRING", "NULLABLE"),
        ("Flex_Coverage_Start_Date", "DATE", "NULLABLE"),
        ("Fryers", "STRING", "NULLABLE"),
        ("Fuelman_Site_ID", "INT64", "NULLABLE"),
        ("Full_Time_Employees", "INT64", "NULLABLE"),
        ("Going_Home_Work", "STRING", "NULLABLE"),
        ("Grub_Hub", "BOOL", "NULLABLE"),
        ("HFTD_System", "STRING", "NULLABLE"),
        ("Heating_Source", "STRING", "NULLABLE"),
        ("High_Flow_Auto_Disp_Cnt", "INT64", "NULLABLE"),
        ("Hours_Closed", "STRING", "NULLABLE"),
        ("In_Store_Available", "BOOL", "NULLABLE"),
        ("Inside_Seating", "INT64", "NULLABLE"),
        ("Interstate", "BOOL", "NULLABLE"),
        ("Kerosene", "BOOL", "NULLABLE"),
        ("Kirk_Key", "BOOL", "NULLABLE"),
        ("Kronos_Maximum_Headcount", "INT64", "NULLABLE"),
        ("Kronos_Minimum_Headcount", "INT64", "NULLABLE"),
        ("Kronos_Store", "STRING", "NULLABLE"),
        ("Kronos_WTK_Rollout_Date", "DATE", "NULLABLE"),
        ("Last_Rebuild_Date", "DATE", "NULLABLE"),
        ("Last_Remodel_Date", "DATE", "NULLABLE"),
        ("Latitude", "FLOAT64", "NULLABLE"),
        ("Locality", "STRING", "NULLABLE"),
        ("Location_Type", "STRING", "NULLABLE"),
        ("Longitude", "FLOAT64", "NULLABLE"),
        ("Lot_Square_Footage", "FLOAT64", "NULLABLE"),
        ("MPD", "INT64", "NULLABLE"),
        ("MTO_Tier", "STRING", "NULLABLE"),
        ("Main_Register", "INT64", "NULLABLE"),
        ("Main_Road_Access_Type", "STRING", "NULLABLE"),
        ("Maint_ASM", "STRING", "NULLABLE"),
        ("Maint_Area", "INT64", "NULLABLE"),
        ("Maint_Car_Wash_Tech", "STRING", "NULLABLE"),
        ("Maint_Equipment_Tech", "STRING", "NULLABLE"),
        ("Maint_FSM", "STRING", "NULLABLE"),
        ("Maint_Facility_Support_Tech", "STRING", "NULLABLE"),
        ("Maint_Geographical_Area", "STRING", "NULLABLE"),
        ("Maint_Sub_Area", "STRING", "NULLABLE"),
        ("Manager_Employee_ID", "INT64", "NULLABLE"),
        ("Manager_Name", "STRING", "NULLABLE"),
        ("Manager_Sheetz_Experience_Years", "INT64", "NULLABLE"),
        ("Manager_Start_Date", "DATE", "NULLABLE"),
        ("Marketing_Zone", "STRING", "NULLABLE"),
        ("Meals_Tax_Percentage", "FLOAT64", "NULLABLE"),
        ("Municipality", "STRING", "NULLABLE"),
        ("NR_Rate", "INT64", "NULLABLE"),
        ("OS_Max_Amount", "INT64", "NULLABLE"),
        ("Occupancy", "INT64", "NULLABLE"),
        ("Online_Ordering", "BOOL", "NULLABLE"),
        ("Open_Date", "DATE", "NULLABLE"),
        ("Other_Tier", "STRING", "NULLABLE"),
        ("OutSide_Seating", "INT64", "NULLABLE"),
        ("Ovens", "STRING", "NULLABLE"),
        ("PSDCode", "INT64", "NULLABLE"),
        ("Parking_Stalls", "INT64", "NULLABLE"),
        ("Part_Time_Employees", "INT64", "NULLABLE"),
        ("Pizza_Oven", "INT64", "NULLABLE"),
        ("Postal_Code", "STRING", "NULLABLE"),
        ("Pre_Live_Date", "DATE", "NULLABLE"),
        ("Private_Systems", "STRING", "NULLABLE"),
        ("Propane", "BOOL", "NULLABLE"),
        ("Pump_Activation", "BOOL", "NULLABLE"),
        ("Pumps_Closed", "BOOL", "NULLABLE"),
        ("RPOS_Major_Revision", "FLOAT64", "NULLABLE"),
        ("RTE_SS_Coffee_Tier", "STRING", "NULLABLE"),
        ("RTE_Tier", "STRING", "NULLABLE"),
        ("RTU_Tonnage", "FLOAT64", "NULLABLE"),
        ("Region_Number", "STRING", "NULLABLE"),
        ("Regional_Manager", "STRING", "NULLABLE"),
        ("Replen_Store_Closing", "DATE", "NULLABLE"),
        ("Replen_Store_Opening", "DATE", "NULLABLE"),
        ("Replen_Temp_Close", "BOOL", "NULLABLE"),
        ("Rollover_Phone_Line", "STRING", "NULLABLE"),
        ("SBC_Tier", "STRING", "NULLABLE"),
        ("SCO_Lanes", "INT64", "NULLABLE"),
        ("SHCAN_Go", "BOOL", "NULLABLE"),
        ("SS_Coffee_Tier", "STRING", "NULLABLE"),
        ("SS_Store_Config_Type", "INT64", "NULLABLE"),
        ("School", "BOOL", "NULLABLE"),
        ("Sells_Alcohol", "BOOL", "NULLABLE"),
        ("Showers", "BOOL", "NULLABLE"),
        ("Side_Road_Access", "STRING", "NULLABLE"),
        ("Signalized_Intersection", "BOOL", "NULLABLE"),
        ("Smart_Safe", "BOOL", "NULLABLE"),
        ("Special_Directions", "STRING", "NULLABLE"),
        ("State", "STRING", "NULLABLE"),
        ("Store_Airport_Lookup", "STRING", "NULLABLE"),
        ("Store_Close_Date", "DATE", "NULLABLE"),
        ("Store_Folder_Redirect", "STRING", "NULLABLE"),
        ("Store_Kronos_ID", "INT64", "NULLABLE"),
        ("Store_Name", "STRING", "NULLABLE"),
        ("Store_Square_Footage", "INT64", "NULLABLE"),
        ("Street", "STRING", "NULLABLE"),
        ("Telephone_Number", "STRING", "NULLABLE"),
        ("Temporarily_Closed", "BOOL", "NULLABLE"),
        ("Tier", "STRING", "NULLABLE"),
        ("Total_Employees", "INT64", "NULLABLE"),
        ("Travel_Center", "BOOL", "NULLABLE"),
        ("Truck_Diesel_Lane_Cnt", "INT64", "NULLABLE"),
        ("Truck_Parking_Spaces", "INT64", "NULLABLE"),
        ("Truck_Scale", "BOOL", "NULLABLE"),
        ("Turnover_Date", "DATE", "NULLABLE"),
        ("Uber_Eats", "BOOL", "NULLABLE"),
        ("VA_ABC_DELIVERY_PERMIT", "STRING", "NULLABLE"),
        ("WV_DMV_Kiosk", "BOOL", "NULLABLE"),
        ("Wage_Area", "STRING", "NULLABLE"),
        ("Washer_Dryer", "INT64", "NULLABLE"),
        ("White_Block_Remodel_Date", "DATE", "NULLABLE"),
        ("WiFi", "BOOL", "NULLABLE"),
        ("Zone", "STRING", "NULLABLE"),
        ("store_status", "STRING", "NULLABLE"),
    ],
    "product_features": [
        ("product_id", "STRING", "REQUIRED"),
        ("product_name", "STRING", "REQUIRED"),
        ("department_code", "STRING", "REQUIRED"),
        ("category_code", "STRING", "REQUIRED"),
        ("size", "STRING", "NULLABLE"),
        ("unit_price", "FLOAT64", "NULLABLE"),
        ("is_hot", "BOOL", "NULLABLE"),
        ("is_cold", "BOOL", "NULLABLE"),
        ("dietary_flags", "STRING", "REPEATED"),
    ],
    "transaction_header_fact": [
        ("store_number", "STRING", "REQUIRED"),
        ("transaction_number", "STRING", "REQUIRED"),
        ("cardnumber", "STRING", "NULLABLE"),
        ("cust_code", "STRING", "NULLABLE"),
        ("transaction_date", "TIMESTAMP", "REQUIRED"),
        ("subtotal", "FLOAT64", "REQUIRED"),
        ("tax", "FLOAT64", "REQUIRED"),
        ("total", "FLOAT64", "REQUIRED"),
        ("item_count", "INT64", "REQUIRED"),
    ],
    "transaction_body_fact": [
        ("store_number", "STRING", "REQUIRED"),
        ("transaction_number", "STRING", "REQUIRED"),
        ("line_number", "INT64", "REQUIRED"),
        ("product_id", "STRING", "REQUIRED"),
        ("quantity", "INT64", "REQUIRED"),
        ("unit_price", "FLOAT64", "REQUIRED"),
        ("extended_price", "FLOAT64", "REQUIRED"),
    ],
}

# Physical-layout hints kept for contract parity (schemas.py:369-414);
# for local parquet they inform file partitioning.
CLUSTERING: Dict[str, List[str]] = {
    "transaction_header_fact": ["cust_code", "store_number"],
    "transaction_body_fact": ["product_id", "store_number"],
}
TIME_PARTITIONING: Dict[str, str] = {
    "transaction_header_fact": "transaction_date",
    "transaction_body_fact": "transaction_date",
}

_PY_TYPES = {
    "STRING": str,
    "INT64": int,
    "FLOAT64": (int, float),
    "BOOL": bool,
    "TIMESTAMP": (int, float, str),
    "DATE": str,               # ISO "YYYY-MM-DD" (BigQuery DATE JSON form)
}


def validate_row(table: str, row: Dict) -> List[str]:
    """Schema-validate one row; returns a list of violations (empty=ok)."""
    if table not in SCHEMA_DEFINITIONS:
        return [f"unknown table {table!r}"]
    errors = []
    cols = {c[0]: c for c in SCHEMA_DEFINITIONS[table]}
    for name, ctype, mode in SCHEMA_DEFINITIONS[table]:
        val = row.get(name)
        if val is None:
            if mode == "REQUIRED":
                errors.append(f"{name}: required")
            continue
        if mode == "REPEATED":
            if not isinstance(val, list):
                errors.append(f"{name}: expected list")
            continue
        if not isinstance(val, _PY_TYPES[ctype]):
            errors.append(f"{name}: expected {ctype}, got {type(val).__name__}")
    for name in row:
        if name not in cols:
            errors.append(f"{name}: not in schema")
    return errors


class DatasetWriter:
    """Schema-validating JSONL table writer — the BigQueryLoader analogue
    (data_loader.py:6-322: batched inserts, clear_table, row counting)."""

    def __init__(self, root: str, batch_size: int = 1000,
                 strict: bool = True):
        self.root = root
        self.batch_size = batch_size  # data_loader.py batches of 1000
        self.strict = strict
        os.makedirs(root, exist_ok=True)

    def _path(self, table: str) -> str:
        return os.path.join(self.root, f"{table}.jsonl")

    def insert_rows(self, table: str, rows: Iterable[Dict]) -> int:
        """Append rows; raises on schema violation when strict."""
        n = 0
        with open(self._path(table), "a") as f:
            buf = []
            for row in rows:
                errs = validate_row(table, row)
                if errs:
                    if self.strict:
                        raise ValueError(f"{table} row invalid: {errs}")
                    continue
                buf.append(json.dumps(row))
                n += 1
                if len(buf) >= self.batch_size:
                    f.write("\n".join(buf) + "\n")
                    buf = []
            if buf:
                f.write("\n".join(buf) + "\n")
        return n

    def clear_table(self, table: str) -> None:
        """TRUNCATE analogue (data_loader.py clear_table)."""
        path = self._path(table)
        if os.path.exists(path):
            os.remove(path)

    def count_rows(self, table: str) -> int:
        path = self._path(table)
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return sum(1 for _ in f)

    def read_rows(self, table: str,
                  where: Optional[callable] = None) -> List[Dict]:
        """Tiny query surface: full scan with an optional row predicate
        (execute_query analogue for local files)."""
        path = self._path(table)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if where is None or where(row):
                    out.append(row)
        return out
