"""TPC-DS data-generator connector.

Role model: presto-tpcds (the reference's second benchmark fixture,
presto-tpcds/ 2,469 LoC wrapping the teradata dsdgen port) — deterministic
generated data for the TPC-DS benchmark schema.

Same counter-based design as the tpch connector (connectors/tpch.py):
every cell is a pure function of ``splitmix64(stream, key)``, so any key
range of any column generates independently and vectorized — no dsdgen
RNG-stream skipping.  Covered tables are the star-schema subset the
engine's TPC-DS query suite exercises (including BASELINE.md's Q72/Q95
configs): date_dim, item, store, warehouse, promotion, customer,
customer_address, customer_demographics, household_demographics, web_site,
store_sales, catalog_sales, catalog_returns, web_sales, web_returns,
inventory.

Dimension tables are fixed at their SF1 sizes; fact tables scale linearly
with ``scale`` (the spec scales dimensions sub-linearly; queries here
validate against a SQL oracle over the SAME data, so exact dsdgen row
counts are not load-bearing — SURVEY §4.7's fixture philosophy).
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.connectors.api import (
    ColumnMetadata, Connector, PageSource, Split, TableHandle, TableSchema,
    TableStatistics,
)
from presto_tpu_torch.connectors.tpch import h64, u_int

# date_dim calendar: 1990-01-01 .. 2002-12-31 (covers every query window)
_D_EPOCH_START = (datetime.date(1990, 1, 1)
                  - datetime.date(1970, 1, 1)).days
_N_DAYS = (datetime.date(2003, 1, 1) - datetime.date(1990, 1, 1)).days
_DATE_SK_BASE = 2450000  # julian-flavored surrogate base

GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000",
                 "Unknown"]
STATES = ["AL", "CA", "GA", "IL", "IN", "KS", "KY", "LA", "MI", "MN", "MO",
          "NC", "NE", "NY", "OH", "OK", "OR", "SD", "TN", "TX", "VA", "WA",
          "WI"]
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accent", "archery", "athletic", "baseball", "basketball",
           "bedding", "blinds", "bracelets", "camcorders", "classical",
           "computers", "country", "custom", "decor", "dresses", "earings",
           "estate", "fiction", "fishing", "fitness"]
BRAND_PREFIX = ["amalg", "edu pack", "expor tuni", "impor to", "scholar",
                "brand", "corp", "maxi", "nameless", "univ"]
COMPANIES = ["pri", "able", "ought", "eing", "bar", "cally"]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
COUNTIES = ["Ziebach County", "Walker County", "Williamson County",
            "Daviess County", "Barrow County", "Fairfield County",
            "Luce County", "Richland County", "Bronx County",
            "Orange County"]
DESC_WORDS = ("quite final young agree small simple important national "
              "different large available current additional able basic "
              "certain close common sure whole possible medical social "
              "central political").split()


def _money(stream: int, keys: np.ndarray, lo: float, hi: float
           ) -> np.ndarray:
    cents = u_int(stream, keys, int(lo * 100), int(hi * 100))
    return cents.astype(np.float64) / 100.0


# one Dictionary per vocabulary, shared by every split of every table:
# kernel caches key on the dictionary binding (token, length), so a
# fresh object per generated batch would re-trace every string kernel
# once per split (the tpch connector's _ENUM_CACHE discipline)
_DICT_CACHE: Dict[tuple, Dictionary] = {}


def _dict(values: List[str]) -> Dictionary:
    key = tuple(values)
    d = _DICT_CACHE.get(key)
    if d is None:
        d = _DICT_CACHE.setdefault(key, Dictionary(values))
    return d


def _pick(stream: int, keys: np.ndarray, vocab: List[str]
          ) -> Tuple[np.ndarray, Dictionary]:
    codes = u_int(stream, keys, 0, len(vocab) - 1).astype(np.int32)
    return codes, _dict(vocab)


class TpcdsGenerator:
    def __init__(self, scale: float = 1.0):
        self.scale = scale
        # full-domain id dictionaries shared by every split (stable
        # (token, length) kernel-cache bindings across splits)
        self._id_dicts: Dict[str, Dictionary] = {}
        f = max(scale, 1e-4)
        self.n_store_sales = max(int(2_880_000 * f), 1000)
        self.n_catalog_sales = max(int(1_440_000 * f), 500)
        self.n_web_sales = max(int(720_000 * f), 300)
        self.n_catalog_returns = self.n_catalog_sales // 10
        self.n_web_returns = self.n_web_sales // 10
        self.n_customer = max(int(100_000 * min(f, 1.0) ** 0.5), 200)
        self.n_cdemo = 19_208
        self.n_hdemo = 7_200
        self.n_item = 18_000 if f >= 1 else max(int(18_000 * f ** 0.5), 100)
        self.n_store = 12
        self.n_warehouse = 5
        self.n_promo = 300
        self.n_web_site = 30
        self.n_address = self.n_customer // 2
        self.n_store_returns = self.n_store_sales // 10
        self.n_reason = 35
        self.n_ship_mode = 20
        self.n_call_center = 6
        self.n_catalog_page = 200
        self.n_web_page = 60
        self.n_income_band = 20
        self.n_time = 86400
        self.n_weeks = _N_DAYS // 7
        # inventory tracks a quarter of items weekly per warehouse; the
        # tracked-item count shrinks with sub-unit scales so the fact
        # ratio to the sales tables stays spec-proportional (~4:1)
        self.inv_items = max(int((self.n_item // 4) * min(1.0, f) ** 0.5),
                             10)
        self.n_inventory = self.n_weeks * self.n_warehouse * self.inv_items


    def _id_dict(self, name: str, fmt: str, domain: int) -> Dictionary:
        d = self._id_dicts.get(name)
        if d is None:
            d = self._id_dicts.setdefault(
                name, Dictionary([fmt.format(k) for k in range(domain)]))
        return d

    # -- dimension generators -------------------------------------------
    def gen_date_dim(self, columns: Sequence[str], lo: int, hi: int
                     ) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        days = _D_EPOCH_START + idx
        dt = days.astype("datetime64[D]")
        ymd = dt.astype("datetime64[M]")
        year = dt.astype("datetime64[Y]").astype(np.int64) + 1970
        month = (ymd.astype(np.int64) % 12) + 1
        dom = (dt - ymd).astype(np.int64) + 1
        cols = []
        for c in columns:
            if c == "d_date_sk":
                cols.append(Column(T.BIGINT, _DATE_SK_BASE + idx))
            elif c == "d_date":
                cols.append(Column(T.DATE, days.astype(np.int32)))
            elif c == "d_year":
                cols.append(Column(T.INTEGER, year.astype(np.int32)))
            elif c == "d_moy":
                cols.append(Column(T.INTEGER, month.astype(np.int32)))
            elif c == "d_dom":
                cols.append(Column(T.INTEGER, dom.astype(np.int32)))
            elif c == "d_qoy":
                cols.append(Column(T.INTEGER,
                                   ((month - 1) // 3 + 1).astype(np.int32)))
            elif c == "d_week_seq":
                cols.append(Column(T.INTEGER, (idx // 7).astype(np.int32)))
            elif c == "d_month_seq":
                seq = (year - 1990) * 12 + month - 1
                cols.append(Column(T.INTEGER, seq.astype(np.int32)))
            elif c == "d_day_name":
                # 1990-01-01 was a Monday
                codes = (idx % 7).astype(np.int32)
                cols.append(Column(T.VARCHAR, codes,
                                   None, _dict(DAY_NAMES)))
            elif c == "d_dow":
                cols.append(Column(T.INTEGER,
                                   ((idx + 1) % 7).astype(np.int32)))
            elif c == "d_quarter_name":
                q = (month - 1) // 3 + 1
                vocab = [f"{y}Q{i}" for y in range(1990, 2004)
                         for i in range(1, 5)]
                codes = ((year - 1990) * 4 + q - 1).astype(np.int32)
                cols.append(Column(T.VARCHAR, codes, None,
                                   _dict(vocab)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_item(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "i_item_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "i_item_id":
                d = self._id_dict("i_item_id", "AAAAAAAA{:08d}",
                                  self.n_item)
                cols.append(Column(T.VARCHAR,
                                   np.arange(lo, hi, dtype=np.int32),
                                   None, d))
            elif c == "i_item_desc":
                w1, _ = _pick(301, keys, DESC_WORDS)
                vocab = [f"{a} {b}" for a in DESC_WORDS[:8]
                         for b in DESC_WORDS]
                codes = u_int(302, keys, 0, len(vocab) - 1).astype(np.int32)
                cols.append(Column(T.VARCHAR, codes, None,
                                   _dict(vocab)))
            elif c == "i_current_price":
                cols.append(Column(T.DOUBLE, _money(303, keys, 0.09, 99.99)))
            elif c == "i_wholesale_cost":
                cols.append(Column(T.DOUBLE, _money(304, keys, 0.05, 70.0)))
            elif c == "i_brand_id":
                cols.append(Column(T.INTEGER, u_int(
                    305, keys, 1001001, 10016017).astype(np.int32)))
            elif c == "i_brand":
                vocab = [f"{p}#{i}" for p in BRAND_PREFIX
                         for i in range(1, 11)]
                codes, d = _pick(306, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_class_id":
                cols.append(Column(T.INTEGER,
                                   u_int(307, keys, 1, 16).astype(np.int32)))
            elif c == "i_class":
                codes, d = _pick(308, keys, CLASSES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_category_id":
                cols.append(Column(T.INTEGER,
                                   u_int(309, keys, 1, 10).astype(np.int32)))
            elif c == "i_category":
                codes, d = _pick(310, keys, CATEGORIES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_manufact_id":
                cols.append(Column(T.INTEGER,
                                   u_int(311, keys, 1, 1000).astype(np.int32)))
            elif c == "i_manager_id":
                cols.append(Column(T.INTEGER,
                                   u_int(312, keys, 1, 100).astype(np.int32)))
            elif c == "i_product_name":
                vocab = [f"{a}{b}" for a in ("ought", "able", "pri", "ese")
                         for b in ("n st", "able", "ought", "anti", "cally")]
                codes, d = _pick(313, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_color":
                vocab = ["red", "green", "blue", "yellow", "black",
                         "white", "purple", "orange", "pink", "brown",
                         "gray", "cyan", "magenta", "olive", "navy"]
                codes, d = _pick(314, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_size":
                vocab = ["small", "medium", "large", "extra large",
                         "economy", "N/A", "petite"]
                codes, d = _pick(315, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_units":
                vocab = ["Each", "Dozen", "Case", "Pallet", "Gross",
                         "Oz", "Lb", "Ton", "Bunch", "Box"]
                codes, d = _pick(316, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "i_manufact":
                vocab = [f"{a}{b}" for a in ("ought", "able", "pri",
                                             "ese", "anti")
                         for b in ("", "n st", "bar", "cally")]
                codes, d = _pick(317, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_store(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "s_store_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "s_store_id":
                d = self._id_dict("s_store_id", "AAAAAAAA{:04d}",
                                  self.n_store)
                cols.append(Column(
                    T.VARCHAR, np.arange(lo, hi, dtype=np.int32), None, d))
            elif c == "s_store_name":
                vocab = ["ought", "able", "pri", "ese", "anti", "cally",
                         "ation", "eing", "n st", "bar"]
                codes, d = _pick(401, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "s_state":
                codes, d = _pick(402, keys, STATES[:9])
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "s_county":
                codes, d = _pick(403, keys, COUNTIES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "s_gmt_offset":
                cols.append(Column(T.DOUBLE, -5.0 - u_int(
                    404, keys, 0, 3).astype(np.float64)))
            elif c == "s_city":
                vocab = ["Midway", "Fairview", "Oak Grove", "Five Points",
                         "Pleasant Hill", "Centerville"]
                codes, d = _pick(405, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "s_company_id":
                cols.append(Column(T.INTEGER,
                                   np.ones(len(keys), np.int32)))
            elif c == "s_company_name":
                cols.append(Column(T.VARCHAR,
                                   np.zeros(len(keys), np.int32), None,
                                   _dict(["Unknown"])))
            elif c == "s_market_id":
                cols.append(Column(T.INTEGER,
                                   u_int(406, keys, 1, 10)
                                   .astype(np.int32)))
            elif c == "s_number_employees":
                cols.append(Column(T.INTEGER,
                                   u_int(407, keys, 200, 300)
                                   .astype(np.int32)))
            elif c == "s_street_number":
                d = _dict([str(n) for n in range(1, 1001)])
                cols.append(Column(T.VARCHAR,
                                   u_int(408, keys, 0, 999)
                                   .astype(np.int32), None, d))
            elif c == "s_street_name":
                vocab = ["Main", "Oak", "Park", "First", "Second",
                         "Elm", "Cedar", "Maple"]
                codes, d = _pick(409, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "s_street_type":
                vocab = ["St", "Ave", "Blvd", "Ct", "Dr", "Ln", "Rd"]
                codes, d = _pick(410, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "s_suite_number":
                d = _dict([f"Suite {n}" for n in range(0, 100, 10)])
                cols.append(Column(T.VARCHAR,
                                   u_int(411, keys, 0, 9)
                                   .astype(np.int32), None, d))
            elif c == "s_zip":
                d = _dict([f"{z:05d}" for z in range(10000, 10200)])
                cols.append(Column(T.VARCHAR,
                                   u_int(412, keys, 0, 199)
                                   .astype(np.int32), None, d))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_warehouse(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "w_warehouse_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "w_warehouse_name":
                names = ["Conventional childr", "Important issues liv",
                         "Doors canno", "Bad cards must make.",
                         "Operations wou"]
                d = _dict(names)
                cols.append(Column(T.VARCHAR,
                                   (keys % len(names)).astype(np.int32),
                                   None, d))
            elif c == "w_state":
                codes, d = _pick(501, keys, STATES[:6])
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "w_warehouse_sq_ft":
                cols.append(Column(T.INTEGER,
                                   u_int(502, keys, 50_000, 990_000)
                                   .astype(np.int32)))
            elif c == "w_city":
                vocab = ["Midway", "Fairview", "Oak Grove", "Five Points",
                         "Pleasant Hill"]
                codes, d = _pick(503, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "w_county":
                codes, d = _pick(504, keys, COUNTIES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "w_country":
                cols.append(Column(
                    T.VARCHAR, np.zeros(len(keys), np.int32), None,
                    _dict(["United States"])))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_promotion(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        yn = _dict(["N", "Y"])
        cols = []
        for c in columns:
            if c == "p_promo_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "p_promo_id":
                d = self._id_dict("p_promo_id", "AAAAAAAA{:04d}",
                                  self.n_promo)
                cols.append(Column(
                    T.VARCHAR, np.arange(lo, hi, dtype=np.int32), None, d))
            elif c in ("p_channel_dmail", "p_channel_email",
                       "p_channel_tv", "p_channel_event"):
                stream = 601 + hash(c) % 97
                cols.append(Column(
                    T.VARCHAR, u_int(stream, keys, 0, 1).astype(np.int32),
                    None, yn))
            elif c == "p_promo_name":
                vocab = ["ought", "able", "pri", "ese", "anti"]
                codes, d = _pick(606, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_customer(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "c_customer_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "c_customer_id":
                d = self._id_dict("c_customer_id", "AAAAAAAA{:08d}",
                                  self.n_customer)
                cols.append(Column(
                    T.VARCHAR, np.arange(lo, hi, dtype=np.int32), None, d))
            elif c == "c_current_cdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(701, keys, 1, self.n_cdemo)))
            elif c == "c_current_hdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(702, keys, 1, self.n_hdemo)))
            elif c == "c_current_addr_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(703, keys, 1, self.n_address)))
            elif c == "c_first_name":
                vocab = ["James", "Mary", "John", "Linda", "Robert",
                         "Barbara", "Michael", "Susan", "William", "Lisa"]
                codes, d = _pick(704, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "c_last_name":
                vocab = ["Smith", "Johnson", "Brown", "Jones", "Miller",
                         "Davis", "Wilson", "Moore", "Taylor", "White"]
                codes, d = _pick(705, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "c_birth_country":
                vocab = ["UNITED STATES", "CANADA", "MEXICO", "GERMANY",
                         "JAPAN", "BRAZIL"]
                codes, d = _pick(706, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "c_salutation":
                vocab = ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir", "Miss"]
                codes, d = _pick(707, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "c_preferred_cust_flag":
                cols.append(Column(
                    T.VARCHAR, u_int(708, keys, 0, 1).astype(np.int32),
                    None, _dict(["N", "Y"])))
            elif c == "c_birth_day":
                cols.append(Column(T.INTEGER,
                                   u_int(709, keys, 1, 28)
                                   .astype(np.int32)))
            elif c == "c_birth_month":
                cols.append(Column(T.INTEGER,
                                   u_int(710, keys, 1, 12)
                                   .astype(np.int32)))
            elif c == "c_birth_year":
                cols.append(Column(T.INTEGER,
                                   u_int(711, keys, 1924, 1992)
                                   .astype(np.int32)))
            elif c == "c_email_address":
                d = _dict([f"user{k}@example.com"
                           for k in range(200)])
                cols.append(Column(T.VARCHAR,
                                   u_int(712, keys, 0, 199)
                                   .astype(np.int32), None, d))
            elif c == "c_login":
                d = _dict([f"login{k}" for k in range(200)])
                cols.append(Column(T.VARCHAR,
                                   u_int(713, keys, 0, 199)
                                   .astype(np.int32), None, d))
            elif c == "c_last_review_date_sk":
                cols.append(Column(T.BIGINT, _DATE_SK_BASE + u_int(
                    714, keys, 0, _N_DAYS - 1)))
            elif c == "c_first_sales_date_sk":
                cols.append(Column(T.BIGINT, _DATE_SK_BASE + u_int(
                    715, keys, 0, _N_DAYS - 1)))
            elif c == "c_first_shipto_date_sk":
                cols.append(Column(T.BIGINT, _DATE_SK_BASE + u_int(
                    716, keys, 0, _N_DAYS - 1)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_customer_address(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "ca_address_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "ca_state":
                codes, d = _pick(801, keys, STATES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "ca_county":
                codes, d = _pick(802, keys, COUNTIES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "ca_zip":
                d = _dict([f"{z:05d}" for z in range(10000, 10200)])
                cols.append(Column(
                    T.VARCHAR, u_int(803, keys, 0, 199).astype(np.int32),
                    None, d))
            elif c == "ca_country":
                cols.append(Column(
                    T.VARCHAR, np.zeros(len(keys), np.int32), None,
                    _dict(["United States"])))
            elif c == "ca_gmt_offset":
                cols.append(Column(T.DOUBLE, -5.0 - u_int(
                    804, keys, 0, 3).astype(np.float64)))
            elif c == "ca_street_number":
                d = _dict([str(n) for n in range(1, 1001)])
                cols.append(Column(T.VARCHAR,
                                   u_int(805, keys, 0, 999)
                                   .astype(np.int32), None, d))
            elif c == "ca_street_name":
                vocab = ["Main", "Oak", "Park", "First", "Second",
                         "Elm", "Cedar", "Maple", "Pine", "Hill"]
                codes, d = _pick(806, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "ca_street_type":
                vocab = ["St", "Ave", "Blvd", "Ct", "Dr", "Ln", "Rd",
                         "Way", "Pkwy", "Cir"]
                codes, d = _pick(807, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "ca_suite_number":
                d = _dict([f"Suite {n}" for n in range(0, 100, 10)])
                cols.append(Column(T.VARCHAR,
                                   u_int(808, keys, 0, 9)
                                   .astype(np.int32), None, d))
            elif c == "ca_city":
                vocab = ["Midway", "Fairview", "Oak Grove", "Five Points",
                         "Pleasant Hill", "Centerville", "Liberty",
                         "Salem", "Greenville", "Bethel"]
                codes, d = _pick(809, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "ca_location_type":
                vocab = ["apartment", "condo", "single family"]
                codes, d = _pick(810, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_customer_demographics(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "cd_demo_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "cd_gender":
                # demographics are a cross-product in the spec: derive
                # attributes positionally so each combination exists
                cols.append(Column(T.VARCHAR, (keys % 2).astype(np.int32),
                                   None, _dict(GENDERS)))
            elif c == "cd_marital_status":
                cols.append(Column(T.VARCHAR,
                                   ((keys // 2) % 5).astype(np.int32),
                                   None, _dict(MARITAL)))
            elif c == "cd_education_status":
                cols.append(Column(T.VARCHAR,
                                   ((keys // 10) % 7).astype(np.int32),
                                   None, _dict(EDUCATION)))
            elif c == "cd_purchase_estimate":
                cols.append(Column(T.INTEGER, (
                    500 + ((keys // 70) % 20) * 500).astype(np.int32)))
            elif c == "cd_credit_rating":
                cols.append(Column(T.VARCHAR,
                                   ((keys // 1400) % 4).astype(np.int32),
                                   None, _dict(CREDIT)))
            elif c == "cd_dep_count":
                cols.append(Column(T.INTEGER,
                                   ((keys // 5600) % 7).astype(np.int32)))
            elif c == "cd_dep_employed_count":
                cols.append(Column(T.INTEGER,
                                   ((keys // 800) % 7).astype(np.int32)))
            elif c == "cd_dep_college_count":
                cols.append(Column(T.INTEGER,
                                   ((keys // 400) % 7).astype(np.int32)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_household_demographics(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "hd_demo_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "hd_income_band_sk":
                cols.append(Column(T.BIGINT, (keys % 20) + 1))
            elif c == "hd_buy_potential":
                cols.append(Column(T.VARCHAR,
                                   ((keys // 20) % 6).astype(np.int32),
                                   None, _dict(BUY_POTENTIAL)))
            elif c == "hd_dep_count":
                cols.append(Column(T.INTEGER,
                                   ((keys // 120) % 10).astype(np.int32)))
            elif c == "hd_vehicle_count":
                cols.append(Column(T.INTEGER,
                                   ((keys // 1200) % 6).astype(np.int32)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_web_site(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "web_site_sk":
                cols.append(Column(T.BIGINT, keys + 1))
            elif c == "web_site_id":
                d = self._id_dict("web_site_id", "AAAAAAAA{:04d}",
                                  self.n_web_site)
                cols.append(Column(
                    T.VARCHAR, np.arange(lo, hi, dtype=np.int32), None, d))
            elif c == "web_name":
                vocab = [f"site_{i}" for i in range(6)]
                codes, d = _pick(901, keys, vocab)
                cols.append(Column(T.VARCHAR, codes, None, d))
            elif c == "web_company_name":
                cols.append(Column(T.VARCHAR,
                                   (keys % len(COMPANIES)).astype(np.int32),
                                   None, _dict(COMPANIES)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    # -- fact generators ------------------------------------------------
    def _sale_common(self, c: str, keys: np.ndarray, prefix: str,
                     n_orders: int) -> Optional[Column]:
        """Columns shared by the three sales channels; ``keys`` are row
        indices; ~8 lines per order (ticket/order number = key // 8)."""
        p = prefix
        if c == f"{p}_sold_date_sk":
            return Column(T.BIGINT, _DATE_SK_BASE + u_int(
                101, keys // 8, 0, _N_DAYS - 1))
        if c == f"{p}_ship_date_sk":
            sold = u_int(101, keys // 8, 0, _N_DAYS - 1)
            lag = u_int(102, keys, 2, 90)
            return Column(T.BIGINT, _DATE_SK_BASE + np.minimum(
                sold + lag, _N_DAYS - 1))
        if c == f"{p}_item_sk":
            return Column(T.BIGINT, u_int(103, keys, 1, self.n_item))
        if c == f"{p}_quantity":
            q = u_int(104, keys, 1, 100)
            null = h64(105, keys) % np.uint64(25) == 0
            return Column(T.INTEGER, q.astype(np.int32), ~null)
        if c == f"{p}_wholesale_cost":
            return Column(T.DOUBLE, _money(106, keys, 1.0, 100.0))
        if c == f"{p}_list_price":
            return Column(T.DOUBLE, _money(107, keys, 1.0, 200.0))
        if c == f"{p}_sales_price":
            return Column(T.DOUBLE, _money(108, keys, 0.0, 200.0))
        if c == f"{p}_ext_sales_price":
            q = u_int(104, keys, 1, 100).astype(np.float64)
            return Column(T.DOUBLE, _money(108, keys, 0.0, 200.0) * q)
        if c == f"{p}_ext_list_price":
            q = u_int(104, keys, 1, 100).astype(np.float64)
            return Column(T.DOUBLE, _money(107, keys, 1.0, 200.0) * q)
        if c == f"{p}_ext_discount_amt":
            return Column(T.DOUBLE, _money(109, keys, 0.0, 1000.0))
        if c == f"{p}_ext_wholesale_cost":
            q = u_int(104, keys, 1, 100).astype(np.float64)
            return Column(T.DOUBLE, _money(106, keys, 1.0, 100.0) * q)
        if c == f"{p}_net_profit":
            return Column(T.DOUBLE, _money(110, keys, -500.0, 1500.0))
        if c == f"{p}_net_paid":
            q = u_int(104, keys, 1, 100).astype(np.float64)
            return Column(T.DOUBLE, _money(108, keys, 0.0, 200.0) * q)
        if c == f"{p}_promo_sk":
            sk = u_int(111, keys, 1, self.n_promo)
            null = h64(112, keys) % np.uint64(2) == 0  # half un-promoted
            return Column(T.BIGINT, sk, ~null)
        if c == f"{p}_coupon_amt":
            return Column(T.DOUBLE, _money(113, keys, 0.0, 50.0))
        if c == f"{p}_ext_tax":
            return Column(T.DOUBLE, _money(114, keys, 0.0, 80.0))
        if c == f"{p}_net_paid_inc_tax":
            q = u_int(104, keys, 1, 100).astype(np.float64)
            return Column(T.DOUBLE, _money(108, keys, 0.0, 200.0) * q
                          + _money(114, keys, 0.0, 80.0))
        if c == f"{p}_sold_time_sk":
            return Column(T.BIGINT, u_int(115, keys // 8, 0, 86399))
        if c == f"{p}_ext_ship_cost":
            return Column(T.DOUBLE, _money(116, keys, 0.0, 500.0))
        return None

    def _return_common(self, c: str, keys: np.ndarray, p: str,
                       sale_row: np.ndarray) -> Optional[Column]:
        """Columns shared by the three returns channels.  Key/sk columns
        that must JOIN back to the originating sale regenerate with the
        SALE's streams over ``sale_row``; measures use fresh streams."""
        if c == f"{p}_item_sk":
            return Column(T.BIGINT, u_int(103, sale_row, 1, self.n_item))
        if c == f"{p}_return_quantity":
            return Column(T.INTEGER,
                          u_int(401, keys, 1, 40).astype(np.int32))
        if c == f"{p}_returned_date_sk":
            return Column(T.BIGINT, _DATE_SK_BASE + u_int(
                402, keys, 0, _N_DAYS - 1))
        if c == f"{p}_return_amt":
            return Column(T.DOUBLE, _money(403, keys, 0.0, 500.0))
        if c == f"{p}_return_amt_inc_tax":
            return Column(T.DOUBLE, _money(403, keys, 0.0, 500.0)
                          + _money(404, keys, 0.0, 40.0))
        if c == f"{p}_net_loss":
            return Column(T.DOUBLE, _money(405, keys, 0.0, 300.0))
        if c == f"{p}_fee":
            return Column(T.DOUBLE, _money(406, keys, 0.0, 100.0))
        if c == f"{p}_refunded_cash":
            return Column(T.DOUBLE, _money(407, keys, 0.0, 500.0))
        if c == f"{p}_reversed_charge":
            return Column(T.DOUBLE, _money(408, keys, 0.0, 200.0))
        if c == f"{p}_store_credit":
            return Column(T.DOUBLE, _money(409, keys, 0.0, 200.0))
        if c == f"{p}_reason_sk":
            return Column(T.BIGINT, u_int(410, keys, 1, self.n_reason))
        if c == f"{p}_returning_customer_sk":
            return Column(T.BIGINT,
                          u_int(411, keys, 1, self.n_customer))
        if c == f"{p}_returning_addr_sk":
            return Column(T.BIGINT, u_int(412, keys, 1, self.n_address))
        if c == f"{p}_returning_cdemo_sk":
            return Column(T.BIGINT, u_int(413, keys, 1, self.n_cdemo))
        if c == f"{p}_refunded_addr_sk":
            return Column(T.BIGINT, u_int(414, keys, 1, self.n_address))
        if c == f"{p}_refunded_cdemo_sk":
            return Column(T.BIGINT, u_int(415, keys, 1, self.n_cdemo))
        return None

    def gen_store_sales(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            shared = self._sale_common(c, keys, "ss", self.n_store_sales)
            if shared is not None:
                cols.append(shared)
            elif c == "ss_ticket_number":
                cols.append(Column(T.BIGINT, keys // 8 + 1))
            elif c == "ss_customer_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(120, keys // 8, 1,
                                         self.n_customer)))
            elif c == "ss_cdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(121, keys // 8, 1, self.n_cdemo)))
            elif c == "ss_hdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(122, keys // 8, 1, self.n_hdemo)))
            elif c == "ss_addr_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(123, keys // 8, 1,
                                         self.n_address)))
            elif c == "ss_store_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(124, keys // 8, 1, self.n_store)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_catalog_sales(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            shared = self._sale_common(c, keys, "cs", self.n_catalog_sales)
            if shared is not None:
                cols.append(shared)
            elif c == "cs_order_number":
                cols.append(Column(T.BIGINT, keys // 8 + 1))
            elif c == "cs_bill_customer_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(130, keys // 8, 1,
                                         self.n_customer)))
            elif c == "cs_bill_cdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(131, keys // 8, 1, self.n_cdemo)))
            elif c == "cs_bill_hdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(132, keys // 8, 1, self.n_hdemo)))
            elif c == "cs_warehouse_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(133, keys, 1, self.n_warehouse)))
            elif c == "cs_ship_addr_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(134, keys // 8, 1,
                                         self.n_address)))
            elif c == "cs_bill_addr_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(135, keys // 8, 1,
                                         self.n_address)))
            elif c == "cs_ship_customer_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(136, keys // 8, 1,
                                         self.n_customer)))
            elif c == "cs_call_center_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(137, keys // 8, 1,
                                         self.n_call_center)))
            elif c == "cs_catalog_page_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(138, keys, 1,
                                         self.n_catalog_page)))
            elif c == "cs_ship_mode_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(139, keys, 1, self.n_ship_mode)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_catalog_returns(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        # returns reference a deterministic subset of catalog_sales rows
        sale_row = (keys * np.int64(10)) % np.int64(self.n_catalog_sales)
        cols = []
        for c in columns:
            shared = self._return_common(c, keys, "cr", sale_row)
            if shared is not None:
                cols.append(shared)
            elif c == "cr_order_number":
                cols.append(Column(T.BIGINT, sale_row // 8 + 1))
            elif c == "cr_call_center_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(420, keys, 1,
                                         self.n_call_center)))
            elif c == "cr_catalog_page_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(421, keys, 1,
                                         self.n_catalog_page)))
            elif c == "cr_return_amount":
                cols.append(Column(T.DOUBLE, _money(403, keys, 0.0, 500.0)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_store_returns(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        sale_row = (keys * np.int64(10)) % np.int64(self.n_store_sales)
        cols = []
        for c in columns:
            shared = self._return_common(c, keys, "sr", sale_row)
            if shared is not None:
                cols.append(shared)
            elif c == "sr_ticket_number":
                cols.append(Column(T.BIGINT, sale_row // 8 + 1))
            elif c == "sr_customer_sk":
                # the originating sale's customer (joins ss & sr on
                # ticket+customer must line up)
                cols.append(Column(T.BIGINT,
                                   u_int(120, sale_row // 8, 1,
                                         self.n_customer)))
            elif c == "sr_cdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(121, sale_row // 8, 1,
                                         self.n_cdemo)))
            elif c == "sr_store_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(124, sale_row // 8, 1,
                                         self.n_store)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_web_sales(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            shared = self._sale_common(c, keys, "ws", self.n_web_sales)
            if shared is not None:
                cols.append(shared)
            elif c == "ws_order_number":
                cols.append(Column(T.BIGINT, keys // 8 + 1))
            elif c == "ws_bill_customer_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(150, keys // 8, 1,
                                         self.n_customer)))
            elif c == "ws_ship_addr_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(151, keys // 8, 1,
                                         self.n_address)))
            elif c == "ws_web_site_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(152, keys // 8, 1,
                                         self.n_web_site)))
            elif c == "ws_warehouse_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(153, keys, 1, self.n_warehouse)))
            elif c == "ws_bill_addr_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(155, keys // 8, 1,
                                         self.n_address)))
            elif c == "ws_ship_customer_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(156, keys // 8, 1,
                                         self.n_customer)))
            elif c == "ws_ship_hdemo_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(157, keys // 8, 1, self.n_hdemo)))
            elif c == "ws_ship_mode_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(158, keys, 1, self.n_ship_mode)))
            elif c == "ws_web_page_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(159, keys // 8, 1,
                                         self.n_web_page)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    def gen_web_returns(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        sale_row = (keys * np.int64(10)) % np.int64(self.n_web_sales)
        cols = []
        for c in columns:
            shared = self._return_common(c, keys, "wr", sale_row)
            if shared is not None:
                cols.append(shared)
            elif c == "wr_order_number":
                cols.append(Column(T.BIGINT, sale_row // 8 + 1))
            elif c == "wr_web_page_sk":
                cols.append(Column(T.BIGINT,
                                   u_int(430, keys, 1, self.n_web_page)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))

    # -- small dimensions added for full-suite coverage ------------------
    def gen_time_dim(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)  # one row per second
        cols = []
        for c in columns:
            if c == "t_time_sk":
                cols.append(Column(T.BIGINT, idx))
            elif c == "t_time":
                cols.append(Column(T.INTEGER, idx.astype(np.int32)))
            elif c == "t_hour":
                cols.append(Column(T.INTEGER,
                                   (idx // 3600).astype(np.int32)))
            elif c == "t_minute":
                cols.append(Column(T.INTEGER,
                                   ((idx % 3600) // 60).astype(np.int32)))
            elif c == "t_second":
                cols.append(Column(T.INTEGER,
                                   (idx % 60).astype(np.int32)))
            elif c == "t_meal_time":
                hour = idx // 3600
                vocab = ["breakfast", "lunch", "dinner"]
                code = np.where(
                    (hour >= 6) & (hour < 9), 0,
                    np.where((hour >= 11) & (hour < 13), 1,
                             np.where((hour >= 17) & (hour < 20), 2, 0)))
                valid = (((hour >= 6) & (hour < 9))
                         | ((hour >= 11) & (hour < 13))
                         | ((hour >= 17) & (hour < 20)))
                cols.append(Column(T.VARCHAR, code.astype(np.int32),
                                   valid, _dict(vocab)))
            elif c == "t_am_pm":
                vocab = ["AM", "PM"]
                cols.append(Column(T.VARCHAR,
                                   (idx // 43200).astype(np.int32), None,
                                   _dict(vocab)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_reason(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "r_reason_sk":
                cols.append(Column(T.BIGINT, idx + 1))
            elif c == "r_reason_id":
                vocab = [f"reason_id_{i}" for i in range(self.n_reason)]
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            elif c == "r_reason_desc":
                vocab = [f"reason {w}" for w in DESC_WORDS[:self.n_reason]]
                while len(vocab) < self.n_reason:
                    vocab.append(f"reason {len(vocab)}")
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_ship_mode(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY"]
        carriers = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS",
                    "ZHOU", "ZOUROS", "MSC", "LATVIAN"]
        cols = []
        for c in columns:
            if c == "sm_ship_mode_sk":
                cols.append(Column(T.BIGINT, idx + 1))
            elif c == "sm_ship_mode_id":
                vocab = [f"ship_mode_{i}" for i in range(self.n_ship_mode)]
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            elif c == "sm_type":
                cols.append(Column(T.VARCHAR,
                                   (idx % len(types)).astype(np.int32),
                                   None, _dict(types)))
            elif c == "sm_carrier":
                cols.append(Column(T.VARCHAR,
                                   (idx % len(carriers)).astype(np.int32),
                                   None, _dict(carriers)))
            elif c == "sm_code":
                vocab = ["AIR", "SURFACE", "SEA"]
                cols.append(Column(T.VARCHAR,
                                   (idx % 3).astype(np.int32), None,
                                   _dict(vocab)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_income_band(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "ib_income_band_sk":
                cols.append(Column(T.BIGINT, idx + 1))
            elif c == "ib_lower_bound":
                cols.append(Column(T.INTEGER,
                                   (idx * 10000).astype(np.int32)))
            elif c == "ib_upper_bound":
                cols.append(Column(T.INTEGER,
                                   ((idx + 1) * 10000).astype(np.int32)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_call_center(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        n = self.n_call_center
        cols = []
        for c in columns:
            if c == "cc_call_center_sk":
                cols.append(Column(T.BIGINT, idx + 1))
            elif c == "cc_call_center_id":
                vocab = [f"cc_id_{i}" for i in range(n)]
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            elif c == "cc_name":
                vocab = ["NY Metro", "Mid Atlantic", "Midwest",
                         "North Midwest", "California", "Pacific NW"]
                cols.append(Column(T.VARCHAR,
                                   (idx % len(vocab)).astype(np.int32),
                                   None, _dict(vocab)))
            elif c == "cc_manager":
                vocab = [f"Manager {i}" for i in range(n)]
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            elif c == "cc_county":
                codes, d = _pick(440, idx, COUNTIES)
                cols.append(Column(T.VARCHAR, codes, None, d))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_catalog_page(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "cp_catalog_page_sk":
                cols.append(Column(T.BIGINT, idx + 1))
            elif c == "cp_catalog_page_id":
                vocab = [f"cp_id_{i}" for i in range(self.n_catalog_page)]
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_web_page(self, columns, lo, hi) -> Batch:
        idx = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "wp_web_page_sk":
                cols.append(Column(T.BIGINT, idx + 1))
            elif c == "wp_web_page_id":
                vocab = [f"wp_id_{i}" for i in range(self.n_web_page)]
                cols.append(Column(T.VARCHAR, idx.astype(np.int32), None,
                                   _dict(vocab)))
            elif c == "wp_char_count":
                cols.append(Column(T.INTEGER,
                                   u_int(450, idx, 100, 8000)
                                   .astype(np.int32)))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(idx))

    def gen_inventory(self, columns, lo, hi) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)
        # row = ((week * n_warehouse) + warehouse) * inv_items + item
        item = keys % self.inv_items
        rest = keys // self.inv_items
        wh = rest % self.n_warehouse
        week = rest // self.n_warehouse
        cols = []
        for c in columns:
            if c == "inv_date_sk":
                cols.append(Column(T.BIGINT, _DATE_SK_BASE + week * 7))
            elif c == "inv_item_sk":
                # inventory covers item_sks spread over the item domain
                step = max(self.n_item // self.inv_items, 1)
                cols.append(Column(T.BIGINT, item * step + 1))
            elif c == "inv_warehouse_sk":
                cols.append(Column(T.BIGINT, wh + 1))
            elif c == "inv_quantity_on_hand":
                q = u_int(170, keys, 0, 1000)
                null = h64(171, keys) % np.uint64(20) == 0
                cols.append(Column(T.INTEGER, q.astype(np.int32), ~null))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(keys))


# ---------------------------------------------------------------------------
# connector
# ---------------------------------------------------------------------------

_B, _I, _D, _V, _DT = T.BIGINT, T.INTEGER, T.DOUBLE, T.VARCHAR, T.DATE

_SCHEMAS: Dict[str, List[Tuple[str, T.Type]]] = {
    "date_dim": [("d_date_sk", _B), ("d_date", _DT), ("d_year", _I),
                 ("d_moy", _I), ("d_dom", _I), ("d_qoy", _I),
                 ("d_week_seq", _I), ("d_month_seq", _I),
                 ("d_day_name", _V), ("d_dow", _I),
                 ("d_quarter_name", _V)],
    "time_dim": [("t_time_sk", _B), ("t_time", _I), ("t_hour", _I),
                 ("t_minute", _I), ("t_second", _I), ("t_meal_time", _V),
                 ("t_am_pm", _V)],
    "item": [("i_item_sk", _B), ("i_item_id", _V), ("i_item_desc", _V),
             ("i_current_price", _D), ("i_wholesale_cost", _D),
             ("i_brand_id", _I), ("i_brand", _V), ("i_class_id", _I),
             ("i_class", _V), ("i_category_id", _I), ("i_category", _V),
             ("i_manufact_id", _I), ("i_manager_id", _I),
             ("i_product_name", _V), ("i_color", _V), ("i_size", _V),
             ("i_units", _V), ("i_manufact", _V)],
    "store": [("s_store_sk", _B), ("s_store_id", _V), ("s_store_name", _V),
              ("s_state", _V), ("s_county", _V), ("s_gmt_offset", _D),
              ("s_city", _V), ("s_company_id", _I),
              ("s_company_name", _V), ("s_market_id", _I),
              ("s_number_employees", _I), ("s_street_number", _V),
              ("s_street_name", _V), ("s_street_type", _V),
              ("s_suite_number", _V), ("s_zip", _V)],
    "warehouse": [("w_warehouse_sk", _B), ("w_warehouse_name", _V),
                  ("w_state", _V), ("w_warehouse_sq_ft", _I),
                  ("w_city", _V), ("w_county", _V), ("w_country", _V)],
    "promotion": [("p_promo_sk", _B), ("p_promo_id", _V),
                  ("p_channel_dmail", _V), ("p_channel_email", _V),
                  ("p_channel_tv", _V), ("p_channel_event", _V),
                  ("p_promo_name", _V)],
    "reason": [("r_reason_sk", _B), ("r_reason_id", _V),
               ("r_reason_desc", _V)],
    "ship_mode": [("sm_ship_mode_sk", _B), ("sm_ship_mode_id", _V),
                  ("sm_type", _V), ("sm_carrier", _V), ("sm_code", _V)],
    "income_band": [("ib_income_band_sk", _B), ("ib_lower_bound", _I),
                    ("ib_upper_bound", _I)],
    "call_center": [("cc_call_center_sk", _B), ("cc_call_center_id", _V),
                    ("cc_name", _V), ("cc_manager", _V),
                    ("cc_county", _V)],
    "catalog_page": [("cp_catalog_page_sk", _B),
                     ("cp_catalog_page_id", _V)],
    "web_page": [("wp_web_page_sk", _B), ("wp_web_page_id", _V),
                 ("wp_char_count", _I)],
    "customer": [("c_customer_sk", _B), ("c_customer_id", _V),
                 ("c_current_cdemo_sk", _B), ("c_current_hdemo_sk", _B),
                 ("c_current_addr_sk", _B), ("c_first_name", _V),
                 ("c_last_name", _V), ("c_birth_country", _V),
                 ("c_salutation", _V), ("c_preferred_cust_flag", _V),
                 ("c_birth_day", _I), ("c_birth_month", _I),
                 ("c_birth_year", _I), ("c_email_address", _V),
                 ("c_login", _V), ("c_last_review_date_sk", _B),
                 ("c_first_sales_date_sk", _B),
                 ("c_first_shipto_date_sk", _B)],
    "customer_address": [("ca_address_sk", _B), ("ca_state", _V),
                         ("ca_county", _V), ("ca_zip", _V),
                         ("ca_country", _V), ("ca_gmt_offset", _D),
                         ("ca_street_number", _V), ("ca_street_name", _V),
                         ("ca_street_type", _V), ("ca_suite_number", _V),
                         ("ca_city", _V), ("ca_location_type", _V)],
    "customer_demographics": [
        ("cd_demo_sk", _B), ("cd_gender", _V), ("cd_marital_status", _V),
        ("cd_education_status", _V), ("cd_purchase_estimate", _I),
        ("cd_credit_rating", _V), ("cd_dep_count", _I),
        ("cd_dep_employed_count", _I), ("cd_dep_college_count", _I)],
    "household_demographics": [
        ("hd_demo_sk", _B), ("hd_income_band_sk", _B),
        ("hd_buy_potential", _V), ("hd_dep_count", _I),
        ("hd_vehicle_count", _I)],
    "web_site": [("web_site_sk", _B), ("web_site_id", _V),
                 ("web_name", _V), ("web_company_name", _V)],
    "store_sales": [
        ("ss_sold_date_sk", _B), ("ss_sold_time_sk", _B),
        ("ss_item_sk", _B), ("ss_customer_sk", _B),
        ("ss_cdemo_sk", _B), ("ss_hdemo_sk", _B), ("ss_addr_sk", _B),
        ("ss_store_sk", _B), ("ss_promo_sk", _B), ("ss_ticket_number", _B),
        ("ss_quantity", _I), ("ss_wholesale_cost", _D),
        ("ss_list_price", _D), ("ss_sales_price", _D),
        ("ss_ext_sales_price", _D), ("ss_ext_discount_amt", _D),
        ("ss_ext_list_price", _D), ("ss_ext_wholesale_cost", _D),
        ("ss_net_profit", _D), ("ss_net_paid", _D),
        ("ss_net_paid_inc_tax", _D), ("ss_coupon_amt", _D),
        ("ss_ext_tax", _D)],
    "store_returns": [
        ("sr_returned_date_sk", _B), ("sr_item_sk", _B),
        ("sr_customer_sk", _B), ("sr_cdemo_sk", _B), ("sr_store_sk", _B),
        ("sr_reason_sk", _B), ("sr_ticket_number", _B),
        ("sr_return_quantity", _I), ("sr_return_amt", _D),
        ("sr_return_amt_inc_tax", _D), ("sr_fee", _D),
        ("sr_refunded_cash", _D), ("sr_reversed_charge", _D),
        ("sr_store_credit", _D), ("sr_net_loss", _D)],
    "catalog_sales": [
        ("cs_sold_date_sk", _B), ("cs_sold_time_sk", _B),
        ("cs_ship_date_sk", _B),
        ("cs_bill_customer_sk", _B), ("cs_bill_cdemo_sk", _B),
        ("cs_bill_hdemo_sk", _B), ("cs_bill_addr_sk", _B),
        ("cs_ship_customer_sk", _B), ("cs_item_sk", _B),
        ("cs_promo_sk", _B),
        ("cs_order_number", _B), ("cs_warehouse_sk", _B),
        ("cs_ship_addr_sk", _B), ("cs_call_center_sk", _B),
        ("cs_catalog_page_sk", _B), ("cs_ship_mode_sk", _B),
        ("cs_quantity", _I),
        ("cs_wholesale_cost", _D), ("cs_list_price", _D),
        ("cs_sales_price", _D), ("cs_ext_sales_price", _D),
        ("cs_ext_list_price", _D), ("cs_net_profit", _D),
        ("cs_ext_discount_amt", _D), ("cs_ext_wholesale_cost", _D),
        ("cs_ext_ship_cost", _D), ("cs_ext_tax", _D),
        ("cs_net_paid", _D), ("cs_net_paid_inc_tax", _D),
        ("cs_coupon_amt", _D)],
    "catalog_returns": [
        ("cr_order_number", _B), ("cr_item_sk", _B),
        ("cr_return_quantity", _I), ("cr_returned_date_sk", _B),
        ("cr_refunded_cash", _D), ("cr_returning_customer_sk", _B),
        ("cr_returning_addr_sk", _B), ("cr_call_center_sk", _B),
        ("cr_catalog_page_sk", _B), ("cr_reason_sk", _B),
        ("cr_return_amount", _D), ("cr_return_amt_inc_tax", _D),
        ("cr_reversed_charge", _D), ("cr_store_credit", _D),
        ("cr_net_loss", _D)],
    "web_sales": [
        ("ws_sold_date_sk", _B), ("ws_sold_time_sk", _B),
        ("ws_ship_date_sk", _B),
        ("ws_item_sk", _B), ("ws_order_number", _B),
        ("ws_bill_customer_sk", _B), ("ws_bill_addr_sk", _B),
        ("ws_ship_customer_sk", _B), ("ws_ship_hdemo_sk", _B),
        ("ws_ship_addr_sk", _B),
        ("ws_web_site_sk", _B), ("ws_web_page_sk", _B),
        ("ws_warehouse_sk", _B), ("ws_ship_mode_sk", _B),
        ("ws_promo_sk", _B),
        ("ws_quantity", _I), ("ws_wholesale_cost", _D),
        ("ws_list_price", _D), ("ws_sales_price", _D),
        ("ws_ext_sales_price", _D),
        ("ws_ext_ship_cost", _D), ("ws_net_profit", _D),
        ("ws_ext_list_price", _D), ("ws_ext_discount_amt", _D),
        ("ws_ext_wholesale_cost", _D), ("ws_ext_tax", _D),
        ("ws_net_paid", _D), ("ws_net_paid_inc_tax", _D),
        ("ws_coupon_amt", _D)],
    "web_returns": [
        ("wr_order_number", _B), ("wr_item_sk", _B),
        ("wr_return_quantity", _I), ("wr_returned_date_sk", _B),
        ("wr_return_amt", _D), ("wr_return_amt_inc_tax", _D),
        ("wr_fee", _D), ("wr_refunded_cash", _D),
        ("wr_reversed_charge", _D), ("wr_net_loss", _D),
        ("wr_reason_sk", _B), ("wr_web_page_sk", _B),
        ("wr_returning_customer_sk", _B), ("wr_returning_addr_sk", _B),
        ("wr_returning_cdemo_sk", _B), ("wr_refunded_addr_sk", _B),
        ("wr_refunded_cdemo_sk", _B)],
    "inventory": [
        ("inv_date_sk", _B), ("inv_item_sk", _B),
        ("inv_warehouse_sk", _B), ("inv_quantity_on_hand", _I)],
}


class _TpcdsPageSource(PageSource):
    def __init__(self, gen: TpcdsGenerator, table: str,
                 columns: Sequence[str], lo: int, hi: int, batch_rows: int):
        self.gen, self.table, self.columns = gen, table, list(columns)
        self.lo, self.hi, self.batch_rows = lo, hi, batch_rows

    def __iter__(self):
        fn = getattr(self.gen, f"gen_{self.table}")
        step = max(self.batch_rows, 1)
        for lo in range(self.lo, self.hi, step):
            yield fn(self.columns, lo, min(lo + step, self.hi))


class TpcdsConnector(Connector):
    """The tpcds catalog: TPC-DS tables generated on the fly."""

    # generated data never changes: whole-query programs
    # may cache device-resident scans
    immutable_data = True

    name = "tpcds"

    def __init__(self, scale: float = 1.0):
        self.generator = TpcdsGenerator(scale)
        self._schemas = {
            name: TableSchema(name, tuple(
                ColumnMetadata(n, typ) for n, typ in cols))
            for name, cols in _SCHEMAS.items()}

    def _row_count(self, table: str) -> int:
        g = self.generator
        return {
            "date_dim": _N_DAYS, "item": g.n_item, "store": g.n_store,
            "warehouse": g.n_warehouse, "promotion": g.n_promo,
            "customer": g.n_customer, "customer_address": g.n_address,
            "customer_demographics": g.n_cdemo,
            "household_demographics": g.n_hdemo,
            "web_site": g.n_web_site, "store_sales": g.n_store_sales,
            "store_returns": g.n_store_returns,
            "catalog_sales": g.n_catalog_sales,
            "catalog_returns": g.n_catalog_returns,
            "web_sales": g.n_web_sales, "web_returns": g.n_web_returns,
            "inventory": g.n_inventory, "time_dim": g.n_time,
            "reason": g.n_reason, "ship_mode": g.n_ship_mode,
            "income_band": g.n_income_band,
            "call_center": g.n_call_center,
            "catalog_page": g.n_catalog_page, "web_page": g.n_web_page,
        }[table]

    def list_tables(self) -> List[str]:
        return sorted(self._schemas)

    def get_table(self, table: str) -> Optional[TableHandle]:
        if table not in self._schemas:
            raise KeyError(f"tpcds table not found: {table}")
        return TableHandle("tpcds", table)

    def table_schema(self, handle: TableHandle) -> TableSchema:
        return self._schemas[handle.table]

    def table_statistics(self, handle: TableHandle
                         ) -> Optional[TableStatistics]:
        return TableStatistics(row_count=self._row_count(handle.table))

    def get_splits(self, handle: TableHandle,
                   desired_splits: int) -> List[Split]:
        n = self._row_count(handle.table)
        desired = max(1, min(desired_splits, max(n // 1024, 1)))
        per = -(-n // desired)
        return [Split(handle, (lo, min(lo + per, n)),
                      estimated_rows=min(per, n - lo))
                for lo in range(0, n, per)]

    def page_source(self, split: Split, columns: Sequence[str],
                    batch_rows: int = 65536) -> PageSource:
        lo, hi = split.info
        return _TpcdsPageSource(self.generator, split.handle.table,
                                columns, lo, hi, batch_rows)
