"""The RTC client of Train-Deploy Alignment: the rounds a robot runs against a served RTC policy."""
