"""A table's schema and indexing from a configuration's plain JSON, in the
program's own types (imported when called, so that the reference and the
tests of the generator never import the program)."""
from __future__ import annotations


def table(name: str, spec: dict):
    """(Schema, TableConfig) of a table spec: {"string": [...], "dimension":
    [...], "metric": [...], "no_dictionary": [...]}: strings STRING, the
    others INT; dimensions dictionary-encoded unless listed in
    no_dictionary, metrics raw."""
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    fields = [FieldSpec(n, DataType.STRING) for n in spec.get("string", [])]
    fields += [FieldSpec(n, DataType.INT) for n in spec.get("dimension", [])]
    fields += [FieldSpec(n, DataType.INT, role=FieldRole.METRIC) for n in spec.get("metric", [])]
    cfg = TableConfig(name, indexing=IndexingConfig(no_dictionary_columns=list(spec.get("no_dictionary", []))))
    return Schema(name, fields), cfg


def column_names(spec: dict):
    return list(spec.get("string", [])) + list(spec.get("dimension", [])) + list(spec.get("metric", []))
