"""Full paper-reproduction report on the port: every table/figure, model
vs paper (port of ``examples/hw_efficiency_report.py``).

    PYTHONPATH=src python examples/torch_hw_efficiency_report.py
"""

from repro_torch.core.paper_tables import ALL_TABLES


def md_table(rows):
    keys = list(rows[0])
    out = ["| " + " | ".join(keys) + " |",
           "|" + "---|" * len(keys)]
    for r in rows:
        out.append("| " + " | ".join(str(r[k]) for k in keys) + " |")
    return "\n".join(out)


if __name__ == "__main__":
    for fn in ALL_TABLES:
        rows, ref = fn()
        print(f"\n### {ref}\n")
        print(md_table(rows))
