"""Ingestion input formats (pinot-plugins/pinot-input-format analog): port
of pinot_tpu/ingest/."""
from pinot_tpu_torch.ingest.readers import CsvRecordReader, JsonRecordReader, read_csv_columns

__all__ = ["CsvRecordReader", "JsonRecordReader", "read_csv_columns"]
