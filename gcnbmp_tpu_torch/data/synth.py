"""Synthesize a DrugBank-scale DDI dataset (the port's copy of
examples/make_synth_drugbank.py, over its own ``chem``: the same flags,
the same output files, byte for byte): 546 drug-like molecules + a
structured interaction matrix, in the reference CSV formats.

The reference repo ships no data (its ``dataset/`` README only links to
DrugBank downloads, which require registration), so quality parity at the
reference's scale (546 drugs; stratified split 118158/14769/14769 pairs,
RECORD.txt:56-60) is demonstrated here on a synthetic stand-in: fragment-
assembled drug-like SMILES and a pharmacophore-style interaction rule
(acid-base, aromatic stacking, halogen-bond classes) with label noise —
structured ground truth that a GGNN must read out of the molecular graphs,
with a known Bayes ceiling from the noise rate.

Outputs (under --out):
  drug_list.csv          cid, drugbank_id, smiles         (reference schema)
  drug_drug_matrix.csv   546x546 0/1 matrix, cid columns  (reference schema)
  rule_stats.json        pos rate + per-class counts + noise rate

Usage: python -m gcnbmp_tpu_torch.data.synth --out dataset/synth546 [--multi-label]
       python -m gcnbmp_tpu_torch.data.synth --out dataset/synth1704 --kaist [--n-types 86]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np

from gcnbmp_tpu_torch.chem import mol_from_smiles

# Two-slot scaffold templates (A/B = substituent attachment points).
SCAFFOLDS = [
    "{a}c1ccc({b})cc1",              # para-benzene
    "{a}c1cccc({b})c1",              # meta-benzene
    "{a}c1ccc({b})cn1",              # pyridine
    "{a}c1ccc2ccccc2c1",             # naphthalene (B unused)
    "{a}c1ccc(-c2ccc({b})cc2)cc1",   # biphenyl
    "{a}c1ccc2[nH]c({b})cc2c1",      # indole
    "{a}c1nc({b})cs1",               # thiazole
    "{a}c1cc({b})on1",               # isoxazole
    "{a}C1CCC({b})CC1",              # cyclohexane
    "{a}c1ccc(C{b})cc1",             # benzyl
    "{a}c1ccc(O{b})cc1",             # phenol ether
    "{a}c1ccc(N{b})cc1",             # aniline link
]

# Substituents, tagged with the pharmacophore classes they confer.
#   acid: carboxylic acid / sulfonamide NH   base: amine
#   hal:  halogen                            hb: H-bond donor/acceptor rich
SUBSTITUENTS = [
    ("", set()),
    ("C", set()),
    ("CC", set()),
    ("C(C)C", set()),
    ("OC", {"hb"}),
    ("O", {"hb"}),
    ("N", {"base"}),
    ("NC", {"base"}),
    ("N(C)C", {"base"}),
    ("CCN", {"base"}),
    ("F", {"hal"}),
    ("Cl", {"hal"}),
    ("Br", {"hal"}),
    ("C(=O)O", {"acid", "acid_c"}),
    ("CC(=O)O", {"acid", "acid_c"}),
    ("S(=O)(=O)N", {"acid", "acid_s", "hb"}),
    ("C(=O)N", {"hb"}),
    ("C(=O)OC", {"hb"}),
    ("C#N", set()),
    ("CO", {"hb"}),
]


def enumerate_drugs(n_drugs: int, seed: int):
    """Assemble, validate, and select n_drugs distinct molecules."""
    rng = np.random.default_rng(seed)
    candidates = []
    for scaf, (sa, ca), (sb, cb) in itertools.product(
        SCAFFOLDS, SUBSTITUENTS, SUBSTITUENTS
    ):
        # empty substituent slots leave "()" behind — strip for valid SMILES
        smi = scaf.format(a=sa, b=sb).replace("()", "")
        candidates.append((smi, ca | cb))
    # dedupe by SMILES string; shuffle for scaffold/substituent diversity
    seen, pool = set(), []
    for smi, classes in candidates:
        if smi not in seen:
            seen.add(smi)
            pool.append((smi, classes))
    order = rng.permutation(len(pool))
    drugs = []
    for i in order:
        smi, classes = pool[i]
        try:
            mol = mol_from_smiles(smi)
        except Exception:
            continue
        if not 5 <= mol.num_atoms <= 60:
            continue
        n_aromatic = sum(a.aromatic for a in mol.atoms)
        drugs.append({
            "smiles": smi,
            "classes": classes,
            "n_aromatic": n_aromatic,
            "n_O": sum(a.symbol == "O" for a in mol.atoms),
            "n_N": sum(a.symbol == "N" for a in mol.atoms),
        })
        if len(drugs) == n_drugs:
            break
    if len(drugs) < n_drugs:
        raise SystemExit(
            f"only {len(drugs)} valid molecules enumerated; add fragments"
        )
    return drugs


def interaction_label(d1, d2) -> int:
    """Pharmacophore-style clean interaction rule (before noise)."""
    c1, c2 = d1["classes"], d2["classes"]
    if ("acid" in c1 and "base" in c2) or ("acid" in c2 and "base" in c1):
        return 1
    if d1["n_aromatic"] + d2["n_aromatic"] >= 16 and \
            d1["n_O"] + d2["n_O"] >= 2:
        return 1  # aromatic stacking + polar contact
    if "hal" in c1 and "hal" in c2 and d1["n_N"] + d2["n_N"] >= 2:
        return 1  # halogen-bond class
    return 0


MULTI_LABEL_TYPES = [
    "carboxyl_base", "sulfonamide_base", "stacking", "polar_stack",
    "halogen_bond",
]

# ---------------------------------------------------------------------------
# KAIST-scale mode (--kaist): 1704 drugs x 37 interaction types, the scale
# of the reference's multi-class path (setting.py:33 NUM_DRUGS_KAIST=1704;
# train_ggnn_hole_multi_class_x37.py).  Everything below is used only in
# kaist mode so the default 546-drug outputs stay byte-identical.
# ---------------------------------------------------------------------------

# Extra two-slot scaffolds, each tagged with the pharmacophore classes the
# ring system itself confers (aromatic-N acceptors, NH donors, ...).
KAIST_EXTRA_SCAFFOLDS = [
    ("{a}c1ccc2nc({b})ccc2c1", {"pyr", "naph"}),     # quinoline
    ("{a}c1ncc({b})cn1", {"pyr"}),                   # pyrimidine
    ("{a}c1ccc({b})o1", {"fur"}),                    # furan
    ("{a}C1CCN({b})CC1", {"aliph", "pip"}),          # piperidine
    ("{a}c1ccc2cc({b})ccc2c1", {"naph"}),            # 2,6-naphthalene
]

# Classes conferred by the 12 base scaffolds (same order as SCAFFOLDS).
BASE_SCAFFOLD_CLASSES = [
    set(), set(), {"pyr"}, {"naph"}, {"biph"}, {"ind"},
    {"thz"}, {"isox"}, {"aliph"}, set(), {"pheno"}, {"anil"},
]

# Finer substituent tagging (kaist mode only): SMILES fragment -> classes
# layered on top of the coarse tags in SUBSTITUENTS.
KAIST_SUB_CLASSES = {
    "N": {"base_p"}, "NC": {"base_p"}, "CCN": {"base_p"},
    "N(C)C": {"base_t"},
    "F": {"hal_f"}, "Cl": {"hal_cl"}, "Br": {"hal_br"},
    "C(=O)OC": {"ester"}, "C(=O)N": {"amide"}, "C#N": {"nitrile"},
    "O": {"hydroxyl"}, "CO": {"hydroxyl"}, "OC": {"ether"},
}


def _sym(rule):
    """Lift an ordered class-pair rule to an unordered pair rule."""
    return lambda d1, d2: rule(d1, d2) or rule(d2, d1)


def _pair(ca, cb):
    return _sym(lambda d1, d2: ca in d1["classes"] and cb in d2["classes"])


def _pair_any(ca, cbs):
    return _sym(
        lambda d1, d2: ca in d1["classes"] and bool(cbs & d2["classes"])
    )


def _kaist_type_rules():
    """The 37 interaction-type rules: (name, predicate(d1, d2)).

    Each rule reads only graph-visible structure (functional groups /
    ring systems / atom counts), so a graph encoder can in principle
    reach the noise ceiling — same design as the 5-type rule set above,
    widened to the reference's x37 label-space size.
    """
    rules = []
    # acid-base salt bridges (4)
    for acid, aname in (("acid_c", "carboxyl"), ("acid_s", "sulfonamide")):
        for base, bname in (("base_p", "primary_amine"),
                            ("base_t", "tert_amine")):
            rules.append((f"{aname}_{bname}", _pair(acid, base)))
    # halogen bonds onto aromatic-N acceptors (9)
    for hal, hname in (("hal_f", "f"), ("hal_cl", "cl"), ("hal_br", "br")):
        for acc, accname in (("pyr", "pyridine"), ("thz", "thiazole"),
                             ("isox", "isoxazole")):
            rules.append((f"{hname}_{accname}", _pair(hal, acc)))
    # halogen onto carbonyl acceptors (3)
    for hal, hname in (("hal_f", "f"), ("hal_cl", "cl"), ("hal_br", "br")):
        rules.append(
            (f"{hname}_carbonyl", _pair_any(hal, {"ester", "amide"}))
        )
    # hydrogen-bond donor/acceptor pairs (6)
    for don, dname in (("hydroxyl", "hydroxyl"), ("ind", "indole")):
        for acc, accname in (("pyr", "pyridine"), ("amide", "amide"),
                             ("ester", "ester")):
            rules.append((f"{dname}_{accname}", _pair(don, acc)))
    # amine-acceptor pairs (4)
    rules.append(("amine_nitrile",
                  _sym(lambda d1, d2: bool({"base_p", "base_t"}
                                           & d1["classes"])
                       and "nitrile" in d2["classes"])))
    rules.append(("amine_ester", _pair("base_p", "ester")))
    rules.append(("amine_pyridine", _pair("base_p", "pyr")))
    rules.append(("tert_amine_pyridine", _pair("base_t", "pyr")))
    # aromatic stacking (5)
    rules.append(("stack_heavy",
                  lambda d1, d2: d1["n_aromatic"] + d2["n_aromatic"] >= 16
                  and d1["n_O"] + d2["n_O"] >= 2))
    rules.append(("stack_amine",
                  lambda d1, d2: d1["n_aromatic"] + d2["n_aromatic"] >= 16
                  and d1["n_N"] + d2["n_N"] >= 2))
    rules.append(("naph_naph", _pair("naph", "naph")))
    rules.append(("naph_biph", _pair("naph", "biph")))
    rules.append(("biph_biph", _pair("biph", "biph")))
    # hydrophobic / miscellaneous (6)
    rules.append(("aliph_aliph", _pair("aliph", "aliph")))
    rules.append(("ether_acid", _pair_any("ether", {"acid_c", "acid_s"})))
    rules.append(("furan_halogen",
                  _pair_any("fur", {"hal_f", "hal_cl", "hal_br"})))
    rules.append(("nitrile_halogen",
                  _pair_any("nitrile", {"hal_cl", "hal_br"})))
    rules.append(("aniline_acid", _pair("anil", "acid_c")))
    rules.append(("phenolether_base",
                  _pair_any("pheno", {"base_p", "base_t"})))
    assert len(rules) == 37, len(rules)
    assert len({n for n, _ in rules}) == 37
    return rules


def _x86_type_rules():
    """The 86-type rule set: the 37 KAIST rules plus 49 further
    class-pair interactions over the same graph-visible structure —
    the stand-in for the reference paper's second multi-label regime
    (~86 interaction types read from labels.csv;
    train_ggnn_hole_multi_class_x37.py get_class_num)."""
    rules = _kaist_type_rules()
    extra = []
    for hal, hname in (("hal_f", "f"), ("hal_cl", "cl"), ("hal_br", "br")):
        for acc, an in (("ind", "indole"), ("anil", "aniline"),
                        ("pheno", "phenolether")):
            extra.append((f"x86_{hname}_{an}", _pair(hal, acc)))
    for don, dn in (("hydroxyl", "hydroxyl"), ("ind", "indole")):
        for acc, an in (("thz", "thiazole"), ("isox", "isoxazole"),
                        ("nitrile", "nitrile")):
            extra.append((f"x86_{dn}_{an}", _pair(don, acc)))
    for base, bn in (("base_p", "primary_amine"), ("base_t", "tert_amine")):
        for acc, an in (("thz", "thiazole"), ("isox", "isoxazole"),
                        ("fur", "furan")):
            extra.append((f"x86_{bn}_{an}", _pair(base, acc)))
    for acid, an in (("acid_c", "carboxyl"), ("acid_s", "sulfonamide")):
        for b, bn in (("pyr", "pyridine"), ("anil", "aniline"),
                      ("pheno", "phenolether"), ("ind", "indole")):
            extra.append((f"x86_{an}_{bn}", _pair(acid, b)))
    for c, cn in (("ester", "ester"), ("amide", "amide")):
        for r, rn in (("naph", "naphthalene"), ("biph", "biphenyl")):
            extra.append((f"x86_{cn}_{rn}", _pair(c, r)))
    for acc, an in (("pyr", "pyridine"), ("thz", "thiazole"),
                    ("base_p", "primary_amine")):
        extra.append((f"x86_ether_{an}", _pair("ether", acc)))
    for o, on in (("acid_c", "carboxyl"), ("acid_s", "sulfonamide"),
                  ("hal_cl", "cl"), ("ester", "ester")):
        extra.append((f"x86_pip_{on}", _pair("pip", o)))
    extra.append(("x86_nitrile_pyridine", _pair("nitrile", "pyr")))
    extra.append(("x86_nitrile_amide", _pair("nitrile", "amide")))
    extra.append(("x86_hydroxyl_hydroxyl", _pair("hydroxyl", "hydroxyl")))
    extra.append(("x86_ether_ether", _pair("ether", "ether")))
    extra.append(("x86_naph_pyridine", _pair("naph", "pyr")))
    extra.append(("x86_biphenyl_halogen",
                  _pair_any("biph", {"hal_f", "hal_cl", "hal_br"})))
    extra.append(("x86_stack_halogen",
                  lambda d1, d2: d1["n_aromatic"] + d2["n_aromatic"] >= 16
                  and bool({"hal_f", "hal_cl", "hal_br"}
                           & (d1["classes"] | d2["classes"]))))
    extra.append(("x86_stack_acid",
                  lambda d1, d2: d1["n_aromatic"] + d2["n_aromatic"] >= 16
                  and bool({"acid_c", "acid_s"}
                           & (d1["classes"] | d2["classes"]))))
    extra.append(("x86_heavy_n",
                  lambda d1, d2: d1["n_N"] + d2["n_N"] >= 4))
    rules = rules + extra
    assert len(rules) == 86, len(rules)
    assert len({n for n, _ in rules}) == 86
    return rules


def enumerate_drugs_kaist(n_drugs: int, seed: int):
    """Kaist-mode enumeration: wider scaffold pool, finer class tags."""
    rng = np.random.default_rng(seed)
    scaffolds = (
        [(s, BASE_SCAFFOLD_CLASSES[i]) for i, s in enumerate(SCAFFOLDS)]
        + KAIST_EXTRA_SCAFFOLDS
    )
    candidates = []
    for (scaf, scls), (sa, ca), (sb, cb) in itertools.product(
        scaffolds, SUBSTITUENTS, SUBSTITUENTS
    ):
        smi = scaf.format(a=sa, b=sb).replace("()", "")
        classes = (
            set(scls) | ca | cb
            | KAIST_SUB_CLASSES.get(sa, set())
            | KAIST_SUB_CLASSES.get(sb, set())
        )
        candidates.append((smi, classes))
    seen, pool = set(), []
    for smi, classes in candidates:
        if smi not in seen:
            seen.add(smi)
            pool.append((smi, classes))
    order = rng.permutation(len(pool))
    drugs = []
    for i in order:
        smi, classes = pool[i]
        try:
            mol = mol_from_smiles(smi)
        except Exception:
            continue
        if not 5 <= mol.num_atoms <= 60:
            continue
        drugs.append({
            "smiles": smi,
            "classes": classes,
            "n_aromatic": sum(a.aromatic for a in mol.atoms),
            "n_O": sum(a.symbol == "O" for a in mol.atoms),
            "n_N": sum(a.symbol == "N" for a in mol.atoms),
        })
        if len(drugs) == n_drugs:
            break
    if len(drugs) < n_drugs:
        raise SystemExit(
            f"only {len(drugs)} valid molecules enumerated; add fragments"
        )
    return drugs


def write_kaist(out_dir, n_drugs, seed, noise, max_pairs, n_types=37):
    """KAIST-scale outputs: drug_list.csv + pairs_multilabel.csv (37- or
    86-type ``||``-joined labels, interacting pairs only, reference
    schema) + labels.csv, with per-type flip noise as in
    write_multilabel."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    drugs = enumerate_drugs_kaist(n_drugs, seed)
    os.makedirs(out_dir, exist_ok=True)
    cids = [f"CID{i + 1:04d}" for i in range(len(drugs))]
    dbids = [f"DB{i + 1:05d}" for i in range(len(drugs))]
    pd.DataFrame({
        "cid": cids, "drugbank_id": dbids,
        "smiles": [d["smiles"] for d in drugs],
    }).to_csv(os.path.join(out_dir, "drug_list.csv"), index=False)

    if n_types == 86:
        rules = _x86_type_rules()
    elif n_types == 37:
        rules = _kaist_type_rules()
    else:
        raise SystemExit(f"--n-types must be 37 or 86, got {n_types}")
    names = [n for n, _ in rules]
    n = len(drugs)
    rows = []
    type_counts = {t: 0 for t in names}
    for i in range(n):
        for j in range(i + 1, n):
            types = [t for t, fn in rules if fn(drugs[i], drugs[j])]
            if not types:
                continue
            kept = [t for t in types if rng.random() >= noise]
            for t in names:
                if t not in types and rng.random() < noise / 10:
                    kept.append(t)
            if not kept:
                continue
            rows.append({
                "cid_1": cids[i], "cid_2": cids[j],
                "drugbank_id_1": dbids[i], "drugbank_id_2": dbids[j],
                "smiles_1": drugs[i]["smiles"],
                "smiles_2": drugs[j]["smiles"],
                "label": "||".join(kept),
            })
    if max_pairs and len(rows) > max_pairs:
        keep = rng.choice(len(rows), size=max_pairs, replace=False)
        rows = [rows[k] for k in sorted(keep)]
    for r in rows:
        for t in r["label"].split("||"):
            type_counts[t] += 1
    pd.DataFrame(rows).to_csv(
        os.path.join(out_dir, "pairs_multilabel.csv"), index=False
    )
    pd.DataFrame({"label": names}).to_csv(
        os.path.join(out_dir, "labels.csv"), index=False
    )
    stats = {
        "n_drugs": n, "n_types": len(names), "n_pairs": len(rows),
        "noise": noise, "type_counts": type_counts,
    }
    with open(os.path.join(out_dir, "rule_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats))


def interaction_types(d1, d2) -> list:
    """Multi-label refinement of interaction_label: the (possibly several,
    overlapping) mechanism types behind a positive pair.  The union of all
    types fires exactly when interaction_label fires — the binary matrix
    and the multi-label pair set stay consistent."""
    c1, c2 = d1["classes"], d2["classes"]
    types = []
    for a, b in ((c1, c2), (c2, c1)):
        if "acid_c" in a and "base" in b and "carboxyl_base" not in types:
            types.append("carboxyl_base")
        if "acid_s" in a and "base" in b and "sulfonamide_base" not in types:
            types.append("sulfonamide_base")
    if d1["n_aromatic"] + d2["n_aromatic"] >= 16 and \
            d1["n_O"] + d2["n_O"] >= 2:
        types.append("stacking")
        if d1["n_N"] + d2["n_N"] >= 2:
            types.append("polar_stack")  # overlapping subtype
    if "hal" in c1 and "hal" in c2 and d1["n_N"] + d2["n_N"] >= 2:
        types.append("halogen_bond")
    return types


def write_multilabel(out_dir, drugs, cids, dbids, rng, noise):
    """KAIST-style multi-label pair CSV (one row per interacting pair,
    ``||``-joined type names) + labels.csv class list (reference:
    train_ggnn_hole_multi_class_x37.py get_class_num / parsers_multi.py)."""
    import pandas as pd

    rows = []
    n = len(drugs)
    for i in range(n):
        for j in range(i + 1, n):
            types = interaction_types(drugs[i], drugs[j])
            if not types:
                continue
            # per-type flip noise; drop the pair if no type survives
            kept = [t for t in types if rng.random() >= noise]
            for t in MULTI_LABEL_TYPES:
                if t not in types and rng.random() < noise / 10:
                    kept.append(t)
            if not kept:
                continue
            rows.append({
                "cid_1": cids[i], "cid_2": cids[j],
                "drugbank_id_1": dbids[i], "drugbank_id_2": dbids[j],
                "smiles_1": drugs[i]["smiles"], "smiles_2": drugs[j]["smiles"],
                "label": "||".join(kept),
            })
    pd.DataFrame(rows).to_csv(
        os.path.join(out_dir, "pairs_multilabel.csv"), index=False
    )
    pd.DataFrame({"label": MULTI_LABEL_TYPES}).to_csv(
        os.path.join(out_dir, "labels.csv"), index=False
    )
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n-drugs", type=int, default=546)
    p.add_argument("--noise", type=float, default=0.03)
    p.add_argument("--seed", type=int, default=2018)
    p.add_argument("--multi-label", action="store_true",
                   help="also write pairs_multilabel.csv + labels.csv "
                        "(KAIST x86-style interaction-type labels)")
    p.add_argument("--kaist", action="store_true",
                   help="KAIST-scale mode: --n-drugs drugs (default 1704) "
                        "x 37 interaction types, multi-label outputs only "
                        "(reference: setting.py NUM_DRUGS_KAIST, "
                        "train_ggnn_hole_multi_class_x37.py)")
    p.add_argument("--max-pairs", type=int, default=200_000,
                   help="kaist mode: cap on emitted interacting pairs "
                        "(reference KAIST set is ~192k pairs)")
    p.add_argument("--n-types", type=int, default=37, choices=(37, 86),
                   help="kaist mode: interaction-type count — 37 (x37 "
                        "regime) or 86 (the paper's x86 regime)")
    args = p.parse_args(argv)

    if args.kaist:
        n_drugs = args.n_drugs if args.n_drugs != 546 else 1704
        write_kaist(args.out, n_drugs, args.seed, args.noise,
                    args.max_pairs, n_types=args.n_types)
        return

    import pandas as pd

    rng = np.random.default_rng(args.seed)
    drugs = enumerate_drugs(args.n_drugs, args.seed)
    os.makedirs(args.out, exist_ok=True)

    cids = [f"CID{i + 1:04d}" for i in range(len(drugs))]
    dbids = [f"DB{i + 1:05d}" for i in range(len(drugs))]
    pd.DataFrame({
        "cid": cids, "drugbank_id": dbids,
        "smiles": [d["smiles"] for d in drugs],
    }).to_csv(os.path.join(args.out, "drug_list.csv"), index=False)

    n = len(drugs)
    mat = np.zeros((n, n), np.int32)
    n_clean_pos = n_flipped = 0
    for i in range(n):
        for j in range(i + 1, n):
            y = interaction_label(drugs[i], drugs[j])
            n_clean_pos += y
            if rng.random() < args.noise:
                y = 1 - y
                n_flipped += 1
            mat[i, j] = mat[j, i] = y
    pd.DataFrame(mat, columns=cids).to_csv(
        os.path.join(args.out, "drug_drug_matrix.csv"), index=False
    )

    n_pairs = n * (n - 1) // 2
    stats = {
        "n_drugs": n,
        "n_pairs": n_pairs,
        "pos_rate": float(np.triu(mat, 1).sum() / n_pairs),
        "clean_pos_rate": n_clean_pos / n_pairs,
        "noise": args.noise,
        "n_flipped": n_flipped,
        "class_counts": {
            c: sum(c in d["classes"] for d in drugs)
            for c in ("acid", "base", "hal", "hb")
        },
    }
    if args.multi_label:
        stats["n_multilabel_pairs"] = write_multilabel(
            args.out, drugs, cids, dbids, rng, args.noise
        )
    with open(os.path.join(args.out, "rule_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
