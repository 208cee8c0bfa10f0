"""The port's dataset management (`snuffy_tpu_torch.data.splits`, the rest
of `data.mil_pickle`, the eight `datasets/` CLIs) against the JAX
package's and scikit-learn.

The numpy twins of `train_test_split` and `KFold(shuffle=True)` give
scikit-learn's index lists; the Camelyon16 split, the TCGA patient folds
(CSV bytes equal to pandas'), apply/reverse and `n_shot_subset` equal
`snuffy_tpu.data.splits`'; the SVM parser and `build_mil_pickle` equal
`snuffy_tpu.data.mil_pickle`'s for a seed. The CLIs run in a subprocess
with pandas, scikit-learn and JAX blocked.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import KFold
from sklearn.model_selection import train_test_split as sk_split

from snuffy_tpu.data import mil_pickle as jax_mil
from snuffy_tpu.data import splits as jax_splits
from snuffy_tpu_torch.data import mil_pickle, splits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "snuffy_tpu", "pandas",
           "sklearn", "cv2", "PIL")


@pytest.mark.parametrize("sizes", [range(2, 20), range(20, 45),
                                   range(45, 130, 7)])
def test_split_twins_give_sklearns_index_lists(sizes):
    for n in sizes:
        for seed in (0, 1, 42, 12345):
            for share in (0.2, 0.25, 0.3, 0.5):
                if n - np.ceil(share * n) < 1:
                    continue
                items = [f"s{i}" for i in range(n)]
                assert splits.train_test_split(items, share, seed) == \
                    sk_split(items, test_size=share, random_state=seed)
                arr = np.arange(n) * 3
                for a, b in zip(splits.train_test_split(arr, share, seed),
                                sk_split(arr, test_size=share,
                                         random_state=seed)):
                    np.testing.assert_array_equal(a, b)
            for k in (2, 3, 4, 5, 10):
                if k > n:
                    continue
                want = KFold(k, shuffle=True, random_state=seed).split(
                    np.arange(n))
                for (a, b), (c, d) in zip(splits.kfold(n, k, seed), want):
                    np.testing.assert_array_equal(a, c)
                    np.testing.assert_array_equal(b, d)


def test_split_twins_refuse_as_sklearn_does():
    with pytest.raises(ValueError):
        splits.kfold(3, 4, 0)
    with pytest.raises(ValueError):
        splits.train_test_split([1], 0.5, 0)


def make_single_tree(base, classes, slides=4, patches=3):
    for cls in classes:
        for s in range(slides):
            prefix = "normal" if cls.startswith("0") else "tumor"
            d = os.path.join(base, cls, f"{prefix}_{s:03}")
            os.makedirs(d, exist_ok=True)
            for p in range(patches):
                with open(os.path.join(d, f"{p}_{p}.jpeg"), "w") as f:
                    f.write(f"{cls}{s}{p}")


def listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def write_reference(path, n_normal=7, n_tumor=6, n_test=3):
    pd.DataFrame({
        "image": [f"normal_{i:03}.tif" for i in range(n_normal)]
        + [f"tumor_{i:03}.tiff" for i in range(n_tumor)]
        + [f"test_{i:03}.tif" for i in range(n_test)],
        "type": ["normal"] * n_normal + ["tumor"] * n_tumor
        + ["tumor"] * n_test,
    }).to_csv(path, index=False)


@pytest.mark.parametrize("seed, val", [(42, 0.2), (0, 0.25), (7, 0.3)])
def test_camelyon16_split_apply_and_reverse_match_jax(tmp_path, seed, val):
    ref = str(tmp_path / "reference.csv")
    write_reference(ref)
    got = splits.camelyon16_split_slides(ref, val, seed)
    assert got == jax_splits.camelyon16_split_slides(ref, val, seed)
    assert got["test"] == ["test_000", "test_001", "test_002"]
    trees = {}
    for side, mod in (("port", splits), ("jax", jax_splits)):
        base = str(tmp_path / side / "single")
        make_single_tree(base, ("0_normal", "1_tumor"), slides=7)
        rows = mod.apply_split(base, got, fold=2)
        trees[side] = (listing(base), open(os.path.join(
            base, "fold2", "fold2.csv"), "rb").read(), len(rows))
        assert mod.reverse_split(base, fold=2) == len(rows)
        trees[side] += (listing(base),)
    assert trees["port"] == trees["jax"]


def test_apply_split_with_nothing_to_move_writes_pandas_bytes(tmp_path):
    for side, mod in (("port", splits), ("jax", jax_splits)):
        base = str(tmp_path / side)
        os.makedirs(base)
        mod.apply_split(base, {"train": ["absent"]}, fold=1)
    assert open(tmp_path / "port" / "fold1" / "fold1.csv", "rb").read() == \
        open(tmp_path / "jax" / "fold1" / "fold1.csv", "rb").read()


@pytest.mark.parametrize("n_patients, slides_each, k, seed",
                         [(12, 2, 4, 42), (9, 1, 3, 0), (17, 3, 4, 5),
                          (6, 1, 3, 42)])
def test_tcga_patient_folds_match_pandas_bytes(tmp_path, n_patients,
                                                slides_each, k, seed):
    rng = np.random.default_rng(seed)
    rows = [{"patient": f"TCGA-{i:02}", "slide": f"TCGA-{i:02}-s{j},x"}
            for i in rng.permutation(n_patients) for j in range(slides_each)]
    csv_path = str(tmp_path / "patients.csv")
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    got = splits.tcga_patient_folds(csv_path, str(tmp_path / "port"), k,
                                    0.2, seed)
    want = jax_splits.tcga_patient_folds(csv_path, str(tmp_path / "jax"), k,
                                         0.2, seed)
    assert len(got) == len(want) == k
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
        assert splits.split_from_fold_csv(a) == \
            jax_splits.split_from_fold_csv(b)


@pytest.mark.parametrize("seed", [None, 0, 3])
def test_n_shot_subset_matches_jax(tmp_path, seed):
    for side in ("port", "jax"):
        make_single_tree(str(tmp_path / side / "train"),
                         ("0_normal", "1_tumor"), slides=3, patches=6)
    if seed is None:
        np.random.seed(0)
    got = splits.n_shot_subset(str(tmp_path / "port" / "train"),
                               str(tmp_path / "port" / "shot"), 4, seed)
    want = jax_splits.n_shot_subset(str(tmp_path / "jax" / "train"),
                                    str(tmp_path / "jax" / "shot"), 4, seed)
    assert got == want == 2 * 3 * 4
    if seed is not None:   # None draws fresh entropy on each side
        assert listing(tmp_path / "port" / "shot") == \
            listing(tmp_path / "jax" / "shot")


def write_svm(path, seed, n_bags=30, dim=6):
    """An SVM-format MIL file: a header line, then `inst:bag:class f:v`
    rows, both classes in every bag's label set."""
    rng = np.random.default_rng(seed)
    lines, inst = ["header"], 0
    for b in range(n_bags):
        label = int(b % 2)
        for _ in range(rng.integers(1, 5)):
            feats = " ".join(f"{j}:{rng.normal():.6f}" for j in range(dim))
            lines.append(f"{inst}:{b}:{label} {feats}")
            inst += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("seed", [0, 11])
def test_svm_parser_and_mil_pickle_match_jax(tmp_path, seed):
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side / "Musk")
        write_svm(str(tmp_path / side / "Musk" / "musk1norm.svm"), seed)
    path = str(tmp_path / "port" / "Musk" / "musk1norm.svm")
    got, want = mil_pickle.parse_svm_file(path), jax_mil.parse_svm_file(path)
    assert [e[:3] for e in got] == [e[:3] for e in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[3], b[3])
    outs = []
    for side, mod in (("port", mil_pickle), ("jax", jax_mil)):
        out = mod.build_mil_pickle("musk1", 5, 0.2, str(tmp_path / side),
                                   rng=np.random.default_rng(seed))
        assert os.path.basename(out) == "musk1norm_5folds_0.2split.pkl"
        with open(out, "rb") as f:
            outs.append(pickle.load(f))
    assert [b[0] for b in outs[0]] == [b[0] for b in outs[1]]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(np.stack(list(a[1])),
                                      np.stack(list(b[1])))
    # the port's loader reads what its writer wrote
    tr, va, te = mil_pickle.load_mil_data(
        "musk1", 6, 5, 0, 0.2, str(tmp_path / "port"))
    assert len(tr[0]) + len(va[0]) + len(te[0]) == 30


def run_cli(cwd, module, argv):
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import runpy
        sys.argv = ["cli"] + {list(argv)!r}
        runpy.run_module({module!r}, run_name="__main__")
        leaked = [m for m, mod in sys.modules.items()
                  if m.split(".")[0] in {BLOCKED!r} and mod is not None]
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


PKG = "snuffy_tpu_torch.datasets"


def test_the_eight_dataset_clis_with_pandas_and_sklearn_blocked(tmp_path):
    """Each CLI in a subprocess at its defaults (run from the directory its
    defaults name), its outputs held to the JAX functions the root scripts
    call on a twin tree."""
    # Camelyon16: split, n-shot, reverse
    for side in ("port", "jax"):
        make_single_tree(str(tmp_path / side / "c16" / "single"),
                         ("0_normal", "1_tumor"), slides=7)
        write_reference(str(tmp_path / side / "c16" / "reference.csv"))
    c16 = str(tmp_path / "port" / "c16")
    out = run_cli(c16, f"{PKG}.camelyon16."
                  "train_validation_test_splitter_camelyon", [])
    assert "slides split" in out
    jbase = str(tmp_path / "jax" / "c16" / "single")
    split = jax_splits.camelyon16_split_slides(
        str(tmp_path / "jax" / "c16" / "reference.csv"))
    jax_splits.apply_split(jbase, split)
    assert listing(os.path.join(c16, "single")) == listing(jbase)
    run_cli(c16, f"{PKG}.camelyon16.n_shot_dataset_maker",
            ["--num_files", "2", "--seed", "3"])
    jax_splits.n_shot_subset(os.path.join(jbase, "fold1", "train"),
                             os.path.join(jbase, "fold1", "train_2shot"), 2,
                             3)
    assert listing(os.path.join(c16, "single")) == listing(jbase)
    run_cli(c16, f"{PKG}.camelyon16.train_validation_test_reverse_camelyon",
            [])
    jax_splits.reverse_split(jbase)
    assert listing(os.path.join(c16, "single")) == listing(jbase)

    # TCGA: folds, split, n-shot, reverse
    patients = [f"TCGA-{i:02}" for i in range(8)]
    for side in ("port", "jax"):
        base = tmp_path / side / "tcga"
        make_single_tree(str(base / "single"), ("0_luad", "1_lusc"),
                         slides=0)
        for i, p in enumerate(patients):
            d = base / "single" / ("0_luad" if i % 2 else "1_lusc") / p
            os.makedirs(d)
            (d / "0_0.jpeg").write_text(p)
        pd.DataFrame({"patient": patients, "slide": patients}).to_csv(
            base / "single" / "patients.csv", index=False)
    tcga = str(tmp_path / "port" / "tcga")
    jt = str(tmp_path / "jax" / "tcga")
    run_cli(tcga, f"{PKG}.tcga.fold_generator", [])
    want = jax_splits.tcga_patient_folds(
        os.path.join(jt, "single", "patients.csv"),
        os.path.join(jt, "folds"))
    for path in want:
        assert open(path, "rb").read() == open(os.path.join(
            tcga, "folds", os.path.basename(path)), "rb").read()
    run_cli(tcga, f"{PKG}.tcga.train_validation_test_splitter_tcga", [])
    jax_splits.apply_split(os.path.join(jt, "single"),
                           jax_splits.split_from_fold_csv(want[0]),
                           classes=("0_luad", "1_lusc"))
    assert listing(os.path.join(tcga, "single")) == \
        listing(os.path.join(jt, "single"))
    run_cli(tcga, f"{PKG}.tcga.n_shot_dataset_maker_tcga",
            ["--num_files", "1", "--seed", "0"])
    run_cli(tcga, f"{PKG}.tcga.train_validation_test_reverse_tcga", [])
    jax_splits.n_shot_subset(os.path.join(jt, "single", "fold1", "train"),
                             os.path.join(jt, "single", "fold1",
                                          "train_1shot"), 1, 0)
    jax_splits.reverse_split(os.path.join(jt, "single"),
                             classes=("0_luad", "1_lusc"))
    assert listing(os.path.join(tcga, "single")) == \
        listing(os.path.join(jt, "single"))

    # the MIL pickle
    mil = tmp_path / "port" / "mil"
    os.makedirs(mil / "Musk")
    write_svm(str(mil / "Musk" / "musk1norm.svm"), 2)
    out = run_cli(str(mil), f"{PKG}.mil_dataset.mil_cross_validation",
                  ["--num_folds", "5", "--seed", "4"])
    assert "musk1norm_5folds_0.2split.pkl" in out


@pytest.mark.parametrize("name", [
    "camelyon16/n_shot_dataset_maker",
    "camelyon16/train_validation_test_reverse_camelyon",
    "camelyon16/train_validation_test_splitter_camelyon",
    "mil_dataset/mil_cross_validation",
    "tcga/fold_generator",
    "tcga/n_shot_dataset_maker_tcga",
    "tcga/train_validation_test_reverse_tcga",
    "tcga/train_validation_test_splitter_tcga",
])
def test_dataset_clis_have_the_root_flags(name):
    """The port's parser against the root script's add_argument calls
    (the root scripts build their parser under `__main__`)."""
    import ast
    import importlib

    with open(os.path.join(REPO, "datasets", name + ".py")) as f:
        tree = ast.parse(f.read())
    want = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            want.append((ast.literal_eval(node.args[0]), kw))
    parser = importlib.import_module(
        f"{PKG}.{name.replace('/', '.')}").get_args_parser()
    got = []
    for action in parser._actions[1:]:
        kw = {"default": repr(action.default)}
        if action.type is not None:
            kw["type"] = action.type.__name__
        if action.choices is not None:
            kw["choices"] = repr(list(action.choices))
        if action.nargs is not None:
            kw["nargs"] = repr(action.nargs)
        got.append((action.option_strings[0], kw))
    assert [(n, {k: (v if k != "default" else repr(ast.literal_eval(v)))
                 for k, v in kw.items()}) for n, kw in want] == got
