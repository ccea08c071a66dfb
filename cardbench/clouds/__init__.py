"""Point generators, one module a kind: `generate(params, grid, seed)`
returns a Points of the configuration's size from the seed."""
