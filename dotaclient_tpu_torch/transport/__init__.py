"""The wire: the protobuf codec and the framed TCP lane."""
