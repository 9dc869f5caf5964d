# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: narwhal.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rnarwhal.proto\x12\x07narwhal\"\"\n\x0bTransaction\x12\x13\n\x0btransaction\x18\x01 \x01(\x0c\"\x07\n\x05\x45mpty\"+\n\x11\x43ollectionRequest\x12\x16\n\x0e\x63ollection_ids\x18\x01 \x03(\x0c\"4\n\x0c\x42\x61tchPayload\x12\x0e\n\x06\x64igest\x18\x01 \x01(\x0c\x12\x14\n\x0ctransactions\x18\x02 \x03(\x0c\"`\n\x10\x43ollectionResult\x12\x15\n\rcollection_id\x18\x01 \x01(\x0c\x12&\n\x07\x62\x61tches\x18\x02 \x03(\x0b\x32\x15.narwhal.BatchPayload\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"D\n\x16GetCollectionsResponse\x12*\n\x07results\x18\x01 \x03(\x0b\x32\x19.narwhal.CollectionResult\"*\n\x11ReadCausalRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\x0c\",\n\x12ReadCausalResponse\x12\x16\n\x0e\x63ollection_ids\x18\x01 \x03(\x0c\"#\n\rRoundsRequest\x12\x12\n\npublic_key\x18\x01 \x01(\x0c\"<\n\x0eRoundsResponse\x12\x14\n\x0coldest_round\x18\x01 \x01(\x04\x12\x14\n\x0cnewest_round\x18\x02 \x01(\x04\":\n\x15NodeReadCausalRequest\x12\x12\n\npublic_key\x18\x01 \x01(\x0c\x12\r\n\x05round\x18\x02 \x01(\x04\"0\n\x16NodeReadCausalResponse\x12\x16\n\x0e\x63ollection_ids\x18\x01 \x03(\x0c\"R\n\rValidatorData\x12\x12\n\npublic_key\x18\x01 \x01(\x0c\x12\x14\n\x0cstake_weight\x18\x02 \x01(\x03\x12\x17\n\x0fprimary_address\x18\x03 \x01(\t\"Y\n\x15NewNetworkInfoRequest\x12\x14\n\x0c\x65poch_number\x18\x01 \x01(\r\x12*\n\nvalidators\x18\x02 \x03(\x0b\x32\x16.narwhal.ValidatorData\"S\n\x0fNewEpochRequest\x12\x14\n\x0c\x65poch_number\x18\x01 \x01(\r\x12*\n\nvalidators\x18\x02 \x03(\x0b\x32\x16.narwhal.ValidatorData\"4\n\x19GetPrimaryAddressResponse\x12\x17\n\x0fprimary_address\x18\x01 \x01(\t2\xe2\x01\n\tValidator\x12M\n\x0eGetCollections\x12\x1a.narwhal.CollectionRequest\x1a\x1f.narwhal.GetCollectionsResponse\x12?\n\x11RemoveCollections\x12\x1a.narwhal.CollectionRequest\x1a\x0e.narwhal.Empty\x12\x45\n\nReadCausal\x12\x1a.narwhal.ReadCausalRequest\x1a\x1b.narwhal.ReadCausalResponse2\x98\x01\n\x08Proposer\x12\x39\n\x06Rounds\x12\x16.narwhal.RoundsRequest\x1a\x17.narwhal.RoundsResponse\x12Q\n\x0eNodeReadCausal\x12\x1e.narwhal.NodeReadCausalRequest\x1a\x1f.narwhal.NodeReadCausalResponse2\xd0\x01\n\rConfiguration\x12\x34\n\x08NewEpoch\x12\x18.narwhal.NewEpochRequest\x1a\x0e.narwhal.Empty\x12@\n\x0eNewNetworkInfo\x12\x1e.narwhal.NewNetworkInfoRequest\x1a\x0e.narwhal.Empty\x12G\n\x11GetPrimaryAddress\x12\x0e.narwhal.Empty\x1a\".narwhal.GetPrimaryAddressResponse2\x8c\x01\n\x0cTransactions\x12\x39\n\x11SubmitTransaction\x12\x14.narwhal.Transaction\x1a\x0e.narwhal.Empty\x12\x41\n\x17SubmitTransactionStream\x12\x14.narwhal.Transaction\x1a\x0e.narwhal.Empty(\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'narwhal_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRANSACTION._serialized_start=26
  _TRANSACTION._serialized_end=60
  _EMPTY._serialized_start=62
  _EMPTY._serialized_end=69
  _COLLECTIONREQUEST._serialized_start=71
  _COLLECTIONREQUEST._serialized_end=114
  _BATCHPAYLOAD._serialized_start=116
  _BATCHPAYLOAD._serialized_end=168
  _COLLECTIONRESULT._serialized_start=170
  _COLLECTIONRESULT._serialized_end=266
  _GETCOLLECTIONSRESPONSE._serialized_start=268
  _GETCOLLECTIONSRESPONSE._serialized_end=336
  _READCAUSALREQUEST._serialized_start=338
  _READCAUSALREQUEST._serialized_end=380
  _READCAUSALRESPONSE._serialized_start=382
  _READCAUSALRESPONSE._serialized_end=426
  _ROUNDSREQUEST._serialized_start=428
  _ROUNDSREQUEST._serialized_end=463
  _ROUNDSRESPONSE._serialized_start=465
  _ROUNDSRESPONSE._serialized_end=525
  _NODEREADCAUSALREQUEST._serialized_start=527
  _NODEREADCAUSALREQUEST._serialized_end=585
  _NODEREADCAUSALRESPONSE._serialized_start=587
  _NODEREADCAUSALRESPONSE._serialized_end=635
  _VALIDATORDATA._serialized_start=637
  _VALIDATORDATA._serialized_end=719
  _NEWNETWORKINFOREQUEST._serialized_start=721
  _NEWNETWORKINFOREQUEST._serialized_end=810
  _NEWEPOCHREQUEST._serialized_start=812
  _NEWEPOCHREQUEST._serialized_end=895
  _GETPRIMARYADDRESSRESPONSE._serialized_start=897
  _GETPRIMARYADDRESSRESPONSE._serialized_end=949
  _VALIDATOR._serialized_start=952
  _VALIDATOR._serialized_end=1178
  _PROPOSER._serialized_start=1181
  _PROPOSER._serialized_end=1333
  _CONFIGURATION._serialized_start=1336
  _CONFIGURATION._serialized_end=1544
  _TRANSACTIONS._serialized_start=1547
  _TRANSACTIONS._serialized_end=1687
# @@protoc_insertion_point(module_scope)
