"""`python -m abyss_tpu_torch <tool>` — dispatcher over the port's tools
(the counterpart of `python -m abyss_tpu`)."""

import importlib
import sys

TOOLS = {
    "pe": ("abyss-pe pipeline driver (key=value args: name= k= in= "
           "device=cuda|cpu ...)", "abyss_tpu_torch.pipeline.pe", "main"),
    "bloom-dbg": ("Bloom-filter de Bruijn graph assembler",
                  "abyss_tpu_torch.cli.tools", "bloom_dbg_main"),
    "bloom": ("Bloom filter utility (abyss-bloom: build/union/"
              "intersect/info/compare/kmers/trim/graph)",
              "abyss_tpu_torch.cli.bloom_tool", "main"),
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m abyss_tpu_torch <tool> [args...]\n\ntools:")
        for name, (desc, _, _) in TOOLS.items():
            print(f"  {name:12s} {desc}")
        return 0
    tool = sys.argv[1]
    if tool not in TOOLS:
        print(f"unknown tool: {tool}", file=sys.stderr)
        return 1
    _, module, fn = TOOLS[tool]
    return getattr(importlib.import_module(module), fn)(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main() or 0)
