"""Warehouse-row generators: customers, stores, products, transactions.

Capability-parity with the reference datagen stack (reference:
src/data/generators/loyalty_customer_generator.py:8-147,
store_generator.py:8-668, product_generator.py:8-160,
transaction_generator.py:10-233): the same statistical structure —
state distribution PA .40 / OH .15 / WV .15 / VA .15 / MD .10 / NC .05,
enrollment-status mix, coherent date timelines, store type/profile
weights, category taxonomy with LLM-templated names, hourly visit
weights, Poisson(2.5) baskets clamped [1,8], 80% home-store preference,
6% tax — emitted as schema-conformant rows (ncf_tpu_torch.data.schemas) and an
``Interactions`` training view, generated vectorized instead of
row-by-row Python dicts bound for BigQuery.

The port's copy of ``ncf_tpu/data/generators.py``, over the port's own
``synthetic``, ``schemas`` and ``naming``: the same seeds draw in the same
order, so both packages write the same rows.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ncf_tpu_torch.data.interactions import SECONDS_PER_DAY, Interactions
from ncf_tpu_torch.data.schemas import DatasetWriter
from ncf_tpu_torch.data.synthetic import _catalog, generate_interactions
from ncf_tpu_torch.naming import ProductNameGenerator

# loyalty_customer_generator.py state distribution
STATE_DIST = [("PA", 0.40), ("OH", 0.15), ("WV", 0.15),
              ("VA", 0.15), ("MD", 0.10), ("NC", 0.05)]
# enrollment status mix: active / lapsed / new
ENROLLMENT_DIST = [(1, 0.75), (0, 0.15), (2, 0.10)]
# store_generator.py type weights + location profiles
STORE_TYPES = [("standard", 0.6), ("travel_center", 0.15),
               ("urban", 0.15), ("compact", 0.10)]
LOCATION_PROFILES = {
    "standard": ["suburban", "highway"],
    "travel_center": ["highway", "interstate"],
    "urban": ["downtown", "campus"],
    "compact": ["neighborhood", "downtown"],
}
AMENITIES = {
    "standard": ["fuel", "car_wash", "mto_kitchen", "atm"],
    "travel_center": ["fuel", "diesel", "showers", "parking", "mto_kitchen"],
    "urban": ["mto_kitchen", "coffee_bar", "atm"],
    "compact": ["fuel", "atm"],
}
STATE_LATLON = {  # rough state bounding boxes (store_generator.py analogue)
    "PA": (39.7, 42.0, -80.5, -75.0), "OH": (38.4, 41.9, -84.8, -80.5),
    "WV": (37.2, 40.6, -82.6, -77.7), "VA": (36.5, 39.4, -83.6, -75.2),
    "MD": (37.9, 39.7, -79.4, -75.0), "NC": (33.8, 36.5, -84.3, -75.4),
}


def _choice(rng, pairs):
    vals = [v for v, _ in pairs]
    p = np.asarray([w for _, w in pairs])
    return [vals[i] for i in rng.choice(len(vals), size=1, p=p / p.sum())][0]


def generate_customers(num: int, seed: int = 0,
                       start_day: int = 0) -> List[Dict]:
    """loyalty_customer_dim rows (loyalty_customer_generator.py:8-147)."""
    rng = np.random.default_rng(seed)
    states = [s for s, _ in STATE_DIST]
    sp = np.asarray([w for _, w in STATE_DIST])
    st = rng.choice(len(states), size=num, p=sp / sp.sum())
    en_vals = [v for v, _ in ENROLLMENT_DIST]
    ep = np.asarray([w for _, w in ENROLLMENT_DIST])
    en = rng.choice(len(en_vals), size=num, p=ep / ep.sum())
    # coherent timeline: activation <= first txn <= last txn
    activation = rng.integers(0, 365, num) * SECONDS_PER_DAY
    first_txn = activation + rng.integers(0, 30, num) * SECONDS_PER_DAY
    last_txn = first_txn + rng.integers(0, 300, num) * SECONDS_PER_DAY
    points = rng.gamma(2.0, 500.0, num)
    rows = []
    for i in range(num):
        rows.append({
            "cardnumber": f"7{i:011d}",
            "cust_code": f"C{i:08d}",
            "first_name": f"First{i}",
            "last_name": f"Last{i}",
            "email": f"user{i}@example.com",
            "state": states[st[i]],
            "zip": f"{15000 + int(rng.integers(0, 5000)):05d}",
            "enrollment_status": int(en_vals[en[i]]),
            "activation_date": int(activation[i]),
            "first_transaction_date": int(first_txn[i]),
            "last_transaction_date": int(last_txn[i]),
            "lifetime_points": float(round(points[i], 2)),
            "first_transaction_location_id": f"S{int(rng.integers(0, 100)):04d}",
        })
    return rows


def _iso_date(rng, lo_day: int, hi_day: int) -> str:
    """ISO date between day offsets from 2015-01-01 (BigQuery DATE form)."""
    import datetime

    d = datetime.date(2015, 1, 1) + datetime.timedelta(
        days=int(rng.integers(lo_day, hi_day)))
    return d.isoformat()


def _store_profile(i: int, stype: str, state: str, profile: str,
                   open_iso: str, rng) -> Dict:
    """The reference's full 167-column store profile
    (store_generator.py:8-668), generated with cross-field coherence:
    travel centers get truck/diesel/shower infrastructure, urban stores
    drop fuel and gain delivery partners, EV/car-wash/alcohol fields are
    internally consistent, staffing scales with square footage."""
    travel = stype == "travel_center"
    urban = stype == "urban"
    compact = stype == "compact"
    fuel = not urban
    highway = profile in ("highway", "interstate")

    sqft = int({"standard": 5500, "travel_center": 9000,
                "urban": 3200, "compact": 2600}[stype]
               * (0.85 + 0.3 * rng.random()))
    full_t = max(4, int(sqft / 550 + rng.integers(0, 4)))
    part_t = max(6, int(sqft / 400 + rng.integers(0, 6)))
    ev = bool(rng.random() < (0.45 if highway else 0.2))
    ev_plugs = {
        "EV_PLUGTYPE_CCS": ev and bool(rng.random() < 0.9),
        "EV_PLUGTYPE_CHADEMO": ev and bool(rng.random() < 0.3),
        "EV_PLUGTYPE_J1772": ev and bool(rng.random() < 0.6),
        "EV_PLUGTYPE_NACS": ev and bool(rng.random() < 0.5),
    }
    car_wash = bool(fuel and not compact and rng.random() < 0.4)
    alcohol = bool(state in ("PA", "OH", "WV", "VA") and rng.random() < 0.5)
    mgr_years = int(rng.integers(1, 18))
    tiers = ["A", "B", "C", "D"]
    diesel_pumps = int(rng.integers(2, 8)) if fuel else 0
    truck_lanes = int(rng.integers(4, 10)) if travel else 0
    closed = bool(rng.random() < 0.015)

    return {
        "store_number": int(i),
        "store_number_label": f"{i:05d}",
        "ATM": "Yes" if not urban or rng.random() < 0.7 else "No",
        "Access_Points": int(rng.integers(1, 5)),
        "Alcohol_Type": ("Beer and Wine" if alcohol else "None"),
        "Allow_Pct_Shrink_Grocery": float(round(rng.uniform(0.5, 3.0), 2)),
        "At_Divided_Highway": bool(highway and rng.random() < 0.6),
        "Auto_Diesel_Dispenser_Cnt": diesel_pumps if fuel else 0,
        "BMS_Status": str(rng.choice(["Active", "Planned", "None"])),
        "Beer_Wine": alcohol,
        "Big_6_Ice_Cream": str(rng.choice(["Yes", "No"])),
        "Bitcoin_Kiosk": "Yes" if rng.random() < 0.15 else "No",
        "Board_Market": str(rng.choice(["Core", "Expansion"])),
        "Brand_Refresh": _iso_date(rng, 2000, 3600),
        "Building_Type": ("Travel Center" if travel else
                          "Urban" if urban else "Standard"),
        "Bulk_DEF": travel,
        "Car_Wash_Brand": car_wash,
        "Car_Wash_Region": (f"CW-{state}" if car_wash else "None"),
        "Car_Wash_Type": car_wash and bool(rng.random() < 0.5),
        "Carwash_ICS_Site_ID": (int(10000 + i) if car_wash else 0),
        "Cig_Market": f"{state}-{int(rng.integers(1, 4))}",
        "City": f"{state} City {int(rng.integers(1, 60))}",
        "Close_Date": _iso_date(rng, 4000, 4100) if closed else "",
        "Coffee_Brewers": str(rng.choice(["2", "3", "4"])),
        "Coke_Freestyle": bool(not compact and rng.random() < 0.6),
        "Community": bool(rng.random() < 0.3),
        "Construction_Maintenance": str(
            rng.choice(["None", "Scheduled", "In Progress"],
                       p=[0.85, 0.10, 0.05])),
        "Corner_Location": bool(rng.random() < 0.4),
        "County": f"{state} County {int(rng.integers(1, 30))}",
        "Crypto_Currency_Acceptance": "No",
        "Curbside": bool(urban or rng.random() < 0.3),
        "DMA": f"DMA-{int(rng.integers(500, 600))}",
        "Delivery": bool(urban or rng.random() < 0.4),
        "Diesel": fuel,
        "Diesel_Pumps": diesel_pumps,
        "District_Manager": f"DM {int(rng.integers(1, 40)):02d}",
        "District_Manager_Employee_ID": int(rng.integers(10000, 99999)),
        "District_Number": f"D{int(rng.integers(1, 40)):03d}",
        "Divided_Side_Road": bool(rng.random() < 0.2),
        "Door_Dash": bool(urban or rng.random() < 0.5),
        "Drive_Thru": bool(not urban and rng.random() < 0.25),
        "Drive_Thru_POS_Number": int(rng.integers(90, 99)),
        "E0_Gas": bool(fuel and rng.random() < 0.3),
        "E15_Gas": bool(fuel and rng.random() < 0.5),
        "E85_Gas": bool(fuel and rng.random() < 0.2),
        "EV_Charger_Plug_Type": ("CCS" if ev else "None"),
        "EV_PARKING_TOTAL_STALLS": int(rng.integers(2, 9)) if ev else 0,
        **ev_plugs,
        "EV_POWER_MAX": float(rng.choice([150.0, 350.0])) if ev else 0.0,
        "Electric_Vehicle_Charger": ev,
        "Espresso_Machine": "Yes" if not compact else "No",
        "FEIN": f"25-{int(rng.integers(1000000, 9999999)):07d}",
        "Fax_Telephone_Number": f"814-555-{int(rng.integers(0, 9999)):04d}",
        "Flex_Coverage_Start_Date": _iso_date(rng, 2500, 3600),
        "Fryers": str(rng.choice(["2", "3", "4"])),
        "Fuelman_Site_ID": int(200000 + i) if fuel else 0,
        "Full_Time_Employees": full_t,
        "Going_Home_Work": str(rng.choice(["Home", "Work", "Mixed"])),
        "Grub_Hub": bool(urban and rng.random() < 0.7),
        "HFTD_System": str(rng.choice(["v2", "v3"])),
        "Heating_Source": str(rng.choice(["Gas", "Electric", "Heat Pump"])),
        "High_Flow_Auto_Disp_Cnt": truck_lanes,
        "Hours_Closed": "" if not closed else "00:00-23:59",
        "In_Store_Available": True,
        "Inside_Seating": int(rng.integers(8, 40)) if not compact else 0,
        "Interstate": bool(profile == "interstate"),
        "Kerosene": bool(fuel and rng.random() < 0.25),
        "Kirk_Key": bool(rng.random() < 0.5),
        "Kronos_Maximum_Headcount": full_t + part_t + 4,
        "Kronos_Minimum_Headcount": max(3, full_t // 2),
        "Kronos_Store": f"K{i:05d}",
        "Kronos_WTK_Rollout_Date": _iso_date(rng, 1500, 2500),
        "Last_Rebuild_Date": _iso_date(rng, 0, 2000),
        "Last_Remodel_Date": _iso_date(rng, 2000, 3600),
        "Locality": str(rng.choice(["Urban", "Suburban", "Rural"])),
        "Location_Type": stype,
        "Lot_Square_Footage": float(sqft * rng.uniform(3.0, 6.0)),
        "MPD": int(rng.integers(4, 12)) if fuel else 0,
        "MTO_Tier": str(rng.choice(tiers)),
        "Main_Register": int(rng.integers(2, 6)),
        "Main_Road_Access_Type": str(
            rng.choice(["Direct", "Side Road", "Service Road"])),
        "Maint_ASM": f"ASM {int(rng.integers(1, 20)):02d}",
        "Maint_Area": int(rng.integers(1, 12)),
        "Maint_Car_Wash_Tech": (f"CWT {int(rng.integers(1, 15)):02d}"
                                if car_wash else "None"),
        "Maint_Equipment_Tech": f"EQT {int(rng.integers(1, 25)):02d}",
        "Maint_FSM": f"FSM {int(rng.integers(1, 12)):02d}",
        "Maint_Facility_Support_Tech": f"FST {int(rng.integers(1, 25)):02d}",
        "Maint_Geographical_Area": f"GEO-{state}",
        "Maint_Sub_Area": f"{state}-{int(rng.integers(1, 8))}",
        "Manager_Employee_ID": int(rng.integers(10000, 99999)),
        "Manager_Name": f"Manager {i:04d}",
        "Manager_Sheetz_Experience_Years": mgr_years,
        "Manager_Start_Date": _iso_date(rng, 3000, 3900),
        "Marketing_Zone": f"MZ-{int(rng.integers(1, 10))}",
        "Meals_Tax_Percentage": float(
            round(rng.choice([0.0, 4.0, 5.3, 6.0]), 2)),
        "Municipality": f"{state} Municipality {int(rng.integers(1, 40))}",
        "NR_Rate": int(rng.integers(1, 5)),
        "OS_Max_Amount": int(rng.choice([100, 150, 200])),
        "Occupancy": int(sqft // 30),
        "Online_Ordering": True,
        "Open_Date": open_iso,
        "Other_Tier": str(rng.choice(tiers)),
        "OutSide_Seating": int(rng.integers(0, 16)) if not urban else 0,
        "Ovens": str(rng.choice(["1", "2", "3"])),
        "PSDCode": int(rng.integers(100000, 999999)),
        "Parking_Stalls": int(sqft // 110 + rng.integers(0, 20)),
        "Part_Time_Employees": part_t,
        "Pizza_Oven": int(rng.random() < 0.5),
        "Postal_Code": f"{15000 + int(rng.integers(0, 5000)):05d}",
        "Pre_Live_Date": _iso_date(rng, 0, 200),
        "Private_Systems": str(rng.choice(["Standard", "Enhanced"])),
        "Propane": bool(fuel and rng.random() < 0.4),
        "Pump_Activation": fuel,
        "Pumps_Closed": bool(fuel and closed),
        "RPOS_Major_Revision": float(rng.choice([11.0, 12.0, 12.5])),
        "RTE_SS_Coffee_Tier": str(rng.choice(tiers)),
        "RTE_Tier": str(rng.choice(tiers)),
        "RTU_Tonnage": float(round(sqft / 400 * rng.uniform(0.8, 1.2), 1)),
        "Region_Number": f"R{int(rng.integers(1, 8))}",
        "Regional_Manager": f"RM {int(rng.integers(1, 8)):02d}",
        "Replen_Store_Closing": _iso_date(rng, 4000, 4100) if closed else "",
        "Replen_Store_Opening": open_iso,
        "Replen_Temp_Close": False,
        "Rollover_Phone_Line": str(rng.choice(["Yes", "No"])),
        "SBC_Tier": str(rng.choice(tiers)),
        "SCO_Lanes": int(rng.integers(0, 5)),
        "SHCAN_Go": bool(rng.random() < 0.6),
        "SS_Coffee_Tier": str(rng.choice(tiers)),
        "SS_Store_Config_Type": int(rng.integers(1, 5)),
        "School": bool(profile == "campus"),
        "Sells_Alcohol": alcohol,
        "Showers": travel,
        "Side_Road_Access": str(rng.choice(["Yes", "No"])),
        "Signalized_Intersection": bool(rng.random() < 0.5),
        "Smart_Safe": True,
        "Special_Directions": "",
        "State": state,
        "Store_Airport_Lookup": "",
        "Store_Close_Date": _iso_date(rng, 4000, 4100) if closed else "",
        "Store_Folder_Redirect": f"\\\\stores\\s{i:05d}",
        "Store_Kronos_ID": int(50000 + i),
        "Store_Name": f"Store #{i}",
        "Store_Square_Footage": sqft,
        "Street": f"{int(rng.integers(100, 9999))} Main St",
        "Telephone_Number": f"814-555-{int(rng.integers(0, 9999)):04d}",
        "Temporarily_Closed": False,
        "Tier": str(rng.choice(tiers)),
        "Total_Employees": full_t + part_t,
        "Travel_Center": travel,
        "Truck_Diesel_Lane_Cnt": truck_lanes,
        "Truck_Parking_Spaces": int(rng.integers(10, 60)) if travel else 0,
        "Truck_Scale": bool(travel and rng.random() < 0.5),
        "Turnover_Date": _iso_date(rng, 3000, 3900),
        "Uber_Eats": bool(urban and rng.random() < 0.6),
        "VA_ABC_DELIVERY_PERMIT": ("Active" if alcohol and state == "VA"
                                   else "None"),
        "WV_DMV_Kiosk": bool(state == "WV" and rng.random() < 0.3),
        "Wage_Area": f"WA-{state}-{int(rng.integers(1, 5))}",
        "Washer_Dryer": int(travel) * int(rng.integers(2, 6)),
        "White_Block_Remodel_Date": _iso_date(rng, 2500, 3600),
        "WiFi": True,
        "Zone": f"Z{int(rng.integers(1, 12)):02d}",
        "store_status": "CLOSED" if closed else "OPEN",
    }


def generate_stores(num: int, seed: int = 0) -> List[Dict]:
    """store_dim rows (store_generator.py:8-668): the condensed
    identity/location/profile core the training path has always used,
    plus the reference's full 167-column store profile (round 5 —
    `_store_profile`) so reference store exports round-trip."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(num):
        stype = _choice(rng, STORE_TYPES)
        state = _choice(rng, STATE_DIST)
        lat0, lat1, lon0, lon1 = STATE_LATLON[state]
        open_day = int(rng.integers(0, 3650))
        lat = float(round(lat0 + rng.random() * (lat1 - lat0), 5))
        lon = float(round(lon0 + rng.random() * (lon1 - lon0), 5))
        profile = str(rng.choice(LOCATION_PROFILES[stype]))
        open_iso = _iso_date(rng, open_day, open_day + 1)
        rows.append({
            "location_id": f"S{i:04d}",
            "store_type": stype,
            "state": state,
            "latitude": lat,
            "longitude": lon,
            "location_profile": profile,
            "open_date": open_day * SECONDS_PER_DAY,
            "amenities": AMENITIES[stype],
            **_store_profile(i, stype, state, profile, open_iso, rng),
            "Latitude": lat,
            "Longitude": lon,
        })
    return rows


def generate_products(num: int, seed: int = 0) -> Tuple[List[Dict], np.ndarray, np.ndarray]:
    """product_features rows with generated names
    (product_generator.py:8-160 + the naming subsystem).  Returns
    (rows, item_dept int32[num], item_cat int32[num])."""
    rng = np.random.default_rng(seed)
    item_cat, item_dept, _, item_price, cat_names, dept_names = _catalog(
        num, rng)
    namer = ProductNameGenerator(seed=seed)
    names_by_cat: Dict[int, List] = {}
    for c in np.unique(item_cat):
        count = int((item_cat == c).sum())
        names_by_cat[int(c)] = namer.generate_for_category(
            cat_names[int(c)], count)
    cursor = {int(c): 0 for c in names_by_cat}
    rows = []
    for i in range(num):
        c = int(item_cat[i])
        p = names_by_cat[c][cursor[c]]
        cursor[c] += 1
        rows.append({
            "product_id": f"P{i:06d}",
            "product_name": p.name,
            "department_code": dept_names[int(item_dept[i])],
            "category_code": cat_names[c],
            "size": p.size,
            "unit_price": float(round(item_price[i], 2)),
            "is_hot": p.is_hot,
            "is_cold": p.is_cold,
            "dietary_flags": p.dietary_flags,
        })
    return rows, item_dept, item_cat


def generate_transactions(
    inter: Interactions, num_stores: int = 20, seed: int = 0,
) -> Tuple[List[Dict], List[Dict]]:
    """transaction_header_fact + transaction_body_fact rows from an
    interaction log, re-grouped into visits (transaction_generator.py
    :180-233: header+items with subtotal/6% tax/total, 80% home-store
    preference)."""
    rng = np.random.default_rng(seed)
    home_store = rng.integers(0, num_stores, inter.num_users)
    headers, bodies = [], []
    # group consecutive same-(user, timestamp) rows into one visit
    n = len(inter)
    txn = 0
    i = 0
    while i < n:
        u = int(inter.user_ids[i])
        ts = int(inter.timestamps[i])
        j = i
        while (j < n and int(inter.user_ids[j]) == u
               and int(inter.timestamps[j]) == ts):
            j += 1
        store = int(home_store[u]) if rng.random() < 0.8 else int(
            rng.integers(0, num_stores))
        subtotal = 0.0
        for line, r in enumerate(range(i, j)):
            qty = 1
            unit = float(inter.amounts[r]) / 1.06
            subtotal += unit * qty
            bodies.append({
                "store_number": f"S{store:04d}",
                "transaction_number": f"T{txn:010d}",
                "line_number": line + 1,
                "product_id": f"P{int(inter.item_ids[r]):06d}",
                "quantity": qty,
                "unit_price": round(unit, 4),
                "extended_price": round(unit * qty, 4),
            })
        tax = subtotal * 0.06
        headers.append({
            "store_number": f"S{store:04d}",
            "transaction_number": f"T{txn:010d}",
            "cardnumber": f"7{u:011d}",
            "cust_code": f"C{u:08d}",
            "transaction_date": ts,
            "subtotal": round(subtotal, 4),
            "tax": round(tax, 4),
            "total": round(subtotal + tax, 4),
            "item_count": j - i,
        })
        txn += 1
        i = j
    return headers, bodies


def build_warehouse(
    root: str,
    num_users: int = 1000,
    num_items: int = 200,
    num_stores: int = 20,
    num_days: int = 60,
    seed: int = 0,
) -> Interactions:
    """Generate and persist all five warehouse tables + return the
    Interactions training view (the scripts/1.*/01-02c pipeline in one
    call)."""
    writer = DatasetWriter(root)
    for table in ("loyalty_customer_dim", "store_dim", "product_features",
                  "transaction_header_fact", "transaction_body_fact"):
        writer.clear_table(table)

    writer.insert_rows("loyalty_customer_dim",
                       generate_customers(num_users, seed))
    writer.insert_rows("store_dim", generate_stores(num_stores, seed + 1))
    product_rows, _, _ = generate_products(num_items, seed + 2)
    writer.insert_rows("product_features", product_rows)

    inter = generate_interactions(
        num_users=num_users, num_items=num_items, num_days=num_days,
        seed=seed + 3)
    headers, bodies = generate_transactions(inter, num_stores, seed + 4)
    writer.insert_rows("transaction_header_fact", headers)
    writer.insert_rows("transaction_body_fact", bodies)
    return inter
