"""The data feed of the port: trial catalogs, window indexing, input assembly,
the native host library, datasets, mixers and the loader."""
