#!/usr/bin/env python3
"""Extract exact-rational integrator coefficients into a Python data module.

The reference (/root/reference/integration/src/methods.rs) carries the
standard published Butcher tableaux / multistep coefficients (Dormand-Prince,
Verner, Tsitouras, Cash-Karp, Fehlberg, Blanes-Moan, McLachlan, Forest-Ruth,
PEFRL, Ruth, Adams-Bashforth, Quinlan-Tremaine 1990, Stormer) as exact i128
fractions.  These are mathematical constants from the literature; we extract
them programmatically (far less error-prone than hand transcription) and emit
``ephemeris_explorer_tpu/integrators/tableaux.py`` holding them as
``fractions.Fraction`` values, evaluated to floats at trace time.

Run:  python tools/extract_tableaux.py
"""

from __future__ import annotations

import re
from fractions import Fraction
from pathlib import Path

SRC = Path("/root/reference/integration/src/methods.rs")
COWELL = Path("/root/reference/integration/src/multistep/second_order/cowell.rs")
OUT = Path(__file__).resolve().parent.parent / "ephemeris_explorer_tpu" / "integrators" / "tableaux.py"

text = SRC.read_text()


def strip_underscores(s: str) -> str:
    return s.replace("_", "")


FRAC_RE = re.compile(
    r"frac!\(\s*(-?[\d_]+)\s*,\s*(-?[\d_]+)\s*\)|frac_f64!\(\s*(-?[\d.eE+-]+)\s*\)"
)


def parse_frac_list(body: str) -> list[Fraction]:
    out = []
    for n, d, dec in FRAC_RE.findall(body):
        if dec:
            # frac_f64!(0.245...) -> exact decimal fraction, matching the
            # reference's Ratio::from_f64 (value*10^p / 10^p).
            out.append(Fraction(dec))
        else:
            out.append(Fraction(int(strip_underscores(n)), int(strip_underscores(d))))
    return out


def find_impl_block(trait: str, name: str) -> str:
    """Return the body of `impl <trait> for <name> { ... }` with balanced braces."""
    pat = re.compile(rf"impl\s+{trait}\s+for\s+{name}\s*\{{")
    m = pat.search(text)
    if not m:
        raise KeyError(f"impl {trait} for {name} not found")
    i = m.end()
    depth = 1
    while depth:
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
        i += 1
    return text[m.end() : i - 1]


def extract_const(body: str, const: str) -> str:
    """Extract the expression assigned to `const <name> ...= <expr>;` (balanced)."""
    m = re.search(rf"const\s+{const}\s*[:0-9a-zA-Z&'\[\]<>\s]*=\s*", body)
    if not m:
        raise KeyError(const)
    i = m.end()
    depth = 0
    start = i
    while True:
        c = body[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == ";" and depth == 0:
            return body[start:i]
        i += 1


def parse_int_list(expr: str) -> list[int]:
    return [int(strip_underscores(v)) for v in re.findall(r"-?[\d_]+", expr)]


def parse_nested_frac(expr: str) -> list[list[Fraction]]:
    """Parse `&[ &[...], &[...], ... ]` into rows of Fractions."""
    # remove the outer &[ ... ]
    inner = expr.strip()
    assert inner.startswith("&[")
    inner = inner[2:-1]
    rows: list[list[Fraction]] = []
    depth = 0
    row_start = None
    i = 0
    while i < len(inner):
        c = inner[i]
        if c == "[":
            if depth == 0:
                row_start = i + 1
            depth += 1
        elif c == "]":
            depth -= 1
            if depth == 0:
                rows.append(parse_frac_list(inner[row_start:i]))
        i += 1
    return rows


def resolve_b_from_a(b_expr: str, a_rows: list[list[Fraction]], aname: str = "A") -> list[Fraction]:
    """Handle `Self::<A>[i][j]` references mixed with frac!()."""
    out: list[Fraction] = []
    pat = rf"Self::{aname}\[(\d+)\]\[(\d+)\]|frac!\(\s*(-?[\d_]+)\s*,\s*(-?[\d_]+)\s*\)"
    for tok in re.finditer(pat, b_expr):
        if tok.group(1) is not None:
            out.append(a_rows[int(tok.group(1))][int(tok.group(2))])
        else:
            out.append(Fraction(int(strip_underscores(tok.group(3))), int(strip_underscores(tok.group(4)))))
    return out


def extract_bh(body: str) -> list[Fraction]:
    m = re.search(r"const\s+BH\w*\s*:[^=]*=\s*&\[(.*?)\];", body, re.S)
    if not m:
        raise KeyError("BH")
    return parse_frac_list(m.group(1))


def erk(name: str) -> dict:
    body = find_impl_block("ERKCoefficients", name)
    a = parse_nested_frac(extract_const(body, "A"))
    b = resolve_b_from_a(extract_const(body, "B"), a)
    c = parse_frac_list(extract_const(body, "C"))
    fsal = "FSAL: bool = true" in body
    order = int(re.search(r"ORDER:\s*u16\s*=\s*(\d+)", body).group(1))
    out = {"kind": "erk", "fsal": fsal, "order": order, "a": a, "b": b, "c": c}
    try:
        ebody = find_impl_block("EERKCoefficients", name)
    except KeyError:
        return out
    order_emb = int(re.search(r"ORDER_EMBEDDED:\s*u16\s*=\s*(\d+)", ebody).group(1))
    try:
        bh = extract_bh(ebody)
        # E = B - BH except Fehlberg which uses BH - B (sign only).
        sub_dir = re.search(r"BH\[0\]\.const_sub\(Self::B\[0\]\)", ebody)
        e = [(bh_i - b_i) if sub_dir else (b_i - bh_i) for b_i, bh_i in zip(b, bh)]
    except KeyError:
        # E given directly (e.g. Verner98)
        e = parse_frac_list(extract_const(ebody, "E"))
    out["order_embedded"] = order_emb
    out["e"] = e
    return out


def erkn(name: str) -> dict:
    body = find_impl_block("ERKNCoefficients", name)
    a = parse_nested_frac(extract_const(body, "A"))
    bp = resolve_b_from_a(extract_const(body, "BP"), a)
    bv = resolve_b_from_a(extract_const(body, "BV"), a)
    c = parse_frac_list(extract_const(body, "C"))
    fsal = "FSAL: bool = true" in body
    order = int(re.search(r"ORDER:\s*u16\s*=\s*(\d+)", body).group(1))
    out = {"kind": "erkn", "fsal": fsal, "order": order, "a": a, "bp": bp, "bv": bv, "c": c}
    ebody = find_impl_block("EERKNCoefficients", name)
    order_emb = int(re.search(r"ORDER_EMBEDDED:\s*u16\s*=\s*(\d+)", ebody).group(1))
    out["order_embedded"] = order_emb
    for const, key, base in (("EP", "ep", bp), ("EV", "ev", bv)):
        m = re.search(rf"const\s+{const}[^=]*=\s*\{{(.*?)\}};", ebody, re.S)
        blk = m.group(1)
        if re.search(r"const\s+BH", blk):
            bh = extract_bh(blk)
            out[key] = [b_i - bh_i for b_i, bh_i in zip(base, bh)]
        else:
            out[key] = parse_frac_list(blk)
    return out


def erkng(name: str) -> dict:
    body = find_impl_block("ERKNGCoefficients", name)
    ap = parse_nested_frac(extract_const(body, "AP"))
    av = parse_nested_frac(extract_const(body, "AV"))
    bp = resolve_b_from_a(extract_const(body, "BP"), ap, "AP")
    bv = resolve_b_from_a(extract_const(body, "BV"), av, "AV")
    c = parse_frac_list(extract_const(body, "C"))
    fsal = "FSAL: bool = true" in body
    order = int(re.search(r"ORDER:\s*u16\s*=\s*(\d+)", body).group(1))
    out = {
        "kind": "erkng", "fsal": fsal, "order": order,
        "ap": ap, "av": av, "bp": bp, "bv": bv, "c": c,
    }
    ebody = find_impl_block("EERKNGCoefficients", name)
    out["order_embedded"] = int(re.search(r"ORDER_EMBEDDED:\s*u16\s*=\s*(\d+)", ebody).group(1))
    for const, key, base in (("EP", "ep", bp), ("EV", "ev", bv)):
        expr = extract_const(ebody, const)
        if "BH" in expr:
            bh = extract_bh(expr)
            out[key] = [b_i - bh_i for b_i, bh_i in zip(base, bh)]
        else:
            out[key] = parse_frac_list(expr)
    return out


def srkn(name: str) -> dict:
    body = find_impl_block("SRKNCoefficients", name)
    # Pefrl defines XI/CHI/LAMBDA consts and uses expressions inside frac_f64!;
    # substitute their exact decimal values (Omelyan et al. 2002 PEFRL constants).
    if name == "Pefrl":
        XI = Fraction("0.1786178958448091")
        CHI = Fraction("-0.0662645826698185")
        LAMBDA = Fraction("-0.2123418310626054")
        mid = 1 - 2 * (CHI + XI)
        half_lam = Fraction(1, 2) - LAMBDA
        a = [XI, CHI, mid, CHI, XI]
        b = [Fraction(0), half_lam, LAMBDA, LAMBDA, half_lam]
        return {"kind": "srkn", "fsal": True, "a": a, "b": b}
    a = parse_frac_list(extract_const(body, "A"))
    b = parse_frac_list(extract_const(body, "B"))
    fsal = "FSAL: bool = true" in body
    return {"kind": "srkn", "fsal": fsal, "a": a, "b": b}


def elm1(name: str) -> dict:
    body = find_impl_block("ELM1Coefficients", name)
    return {
        "kind": "elm1",
        "order": int(re.search(r"ORDER:\s*u16\s*=\s*(\d+)", body).group(1)),
        "alpha": parse_int_list(extract_const(body, "ALPHA")),
        "beta_n": parse_int_list(extract_const(body, "BETA_N")),
        "beta_d": parse_int_list(extract_const(body, "BETA_D"))[0],
    }


def elm2(name: str) -> dict:
    body = find_impl_block("ELM2Coefficients", name)
    return {
        "kind": "elm2",
        "order": int(re.search(r"ORDER:\s*u16\s*=\s*(\d+)", body).group(1)),
        "alpha": parse_int_list(extract_const(body, "ALPHA")),
        "beta_n": parse_int_list(extract_const(body, "BETA_N")),
        "beta_d": parse_int_list(extract_const(body, "BETA_D"))[0],
    }


def cowell_tables() -> dict[int, dict]:
    ctext = COWELL.read_text()
    out = {}
    for m in re.finditer(
        r"impl CowellVelocityCoefficients for Cowell<(\d+)>\s*\{(.*?)\n\}", ctext, re.S
    ):
        order = int(m.group(1))
        body = m.group(2)
        beta_n = parse_int_list(
            re.search(r"BETA_N[^=]*=\s*&\[(.*?)\]", body, re.S).group(1)
        )
        beta_d = int(
            strip_underscores(re.search(r"BETA_D[^=]*=\s*([\d_]+)", body).group(1))
        )
        out[order] = {"beta_n": beta_n, "beta_d": beta_d}
    return out


METHODS: dict[str, dict] = {}
for n in ["RK4", "CashKarp45", "DormandPrince54", "DormandPrince87", "Fehlberg45",
          "Verner87", "Verner98", "Tsitouras75"]:
    METHODS[n] = erk(n)
METHODS["Tsitouras75Nystrom"] = erkn("Tsitouras75Nystrom")
METHODS["Fine45"] = erkng("Fine45")
for n in ["BlanesMoan6B", "BlanesMoan11B", "BlanesMoan14A", "ForestRuth",
          "McLachlanO4", "McLachlanSS17", "Pefrl", "Ruth"]:
    METHODS[n] = srkn(n)
for n in ["AdamsBashforth2", "AdamsBashforth3", "AdamsBashforth4",
          "AdamsBashforth5", "AdamsBashforth6"]:
    METHODS[n] = elm1(n)
for n in ["QuinlanTremaine12", "Stormer13"]:
    METHODS[n] = elm2(n)

COWELL_TABLES = cowell_tables()


def frac_repr(f: Fraction) -> str:
    return f"F({f.numerator},{f.denominator})"


def render(v):
    if isinstance(v, Fraction):
        return frac_repr(v)
    if isinstance(v, list):
        return "[" + ",".join(render(x) for x in v) + "]"
    if isinstance(v, bool):
        return repr(v)
    if isinstance(v, (int, str)):
        return repr(v)
    raise TypeError(type(v))


lines = [
    '"""Exact-rational integrator coefficient tables (GENERATED - do not edit).',
    "",
    "Generated by tools/extract_tableaux.py from the published tableaux that the",
    "reference ships in /root/reference/integration/src/methods.rs (Dormand-Prince,",
    "Verner, Tsitouras, Cash-Karp, Fehlberg, Blanes-Moan 2002, McLachlan, Forest-Ruth,",
    "PEFRL, Ruth, Adams-Bashforth, Quinlan-Tremaine 1990 MNRAS 318, Stormer-Cowell).",
    "Coefficients are kept as fractions.Fraction and evaluated to floats (f64, or",
    "hi/lo f32 pairs for the extended precisions) at integrator-construction time.",
    '"""',
    "",
    "from fractions import Fraction as F",
    "",
]
lines.append("METHODS = {")
for name, spec in METHODS.items():
    lines.append(f"  {name!r}: {{")
    for k, v in spec.items():
        lines.append(f"    {k!r}: {render(v)},")
    lines.append("  },")
lines.append("}")
lines.append("")
lines.append("# Cowell velocity-reconstruction coefficients (orders 1..15), used by the")
lines.append("# second-order multistep methods (reference: multistep/second_order/cowell.rs).")
lines.append("COWELL = {")
for order, spec in sorted(COWELL_TABLES.items()):
    lines.append(f"  {order}: {{'beta_n': {spec['beta_n']!r}, 'beta_d': {spec['beta_d']!r}}},")
lines.append("}")
lines.append("")

OUT.write_text("\n".join(lines))
print(f"wrote {OUT}")

# sanity checks
for name, spec in METHODS.items():
    if spec["kind"] == "erk":
        stages = len(spec["b"])
        assert len(spec["c"]) == stages, name
        assert len(spec["a"]) == stages or len(spec["a"]) == stages - 0, name
        # row sums of A match C
        for i, row in enumerate(spec["a"]):
            # Some published tableaux (DP87, Verner) are rational approximations;
            # row sums match C only to ~1e-10.
            assert abs(float(sum(row, Fraction(0)) - spec["c"][i])) < 1e-8, (name, i)
        assert abs(float(sum(spec["b"], Fraction(0)) - 1)) < 1e-12, name
    if spec["kind"] == "srkn":
        assert abs(float(sum(spec["a"], Fraction(0)) - 1)) < 1e-9, (name, "A")
        assert abs(float(sum(spec["b"], Fraction(0)) - 1)) < 1e-9, (name, "B")
print("consistency checks passed:",
      {k: v["kind"] for k, v in METHODS.items()})
