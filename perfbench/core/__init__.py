"""The benchmark's harness: cells found by name (`spec`), inputs and
weights from the seed, the system under test (`program`), the trace's
reduction, the readers' arithmetic and the check. The runners of each
kind of traffic are in perfbench/runners/, the model families in
perfbench/families/."""
