"""Admin tools (pinot-tools PinotAdministrator analog); port of pinot_tpu/tools/."""
