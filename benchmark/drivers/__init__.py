"""The general generators: one driver for each `kind` of traffic mix,
reading the mix's parameters from `traffic/<mix>.json` (see
`benchmark.harness` for the four functions a driver has)."""
