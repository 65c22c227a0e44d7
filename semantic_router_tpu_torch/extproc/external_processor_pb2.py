# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: external_processor.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x18\x65xternal_processor.proto\x12\x19\x65nvoy.service.ext_proc.v3\"<\n\x0bHeaderValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x11\n\traw_value\x18\x03 \x01(\x0c\"\xa2\x02\n\x11HeaderValueOption\x12\x36\n\x06header\x18\x01 \x01(\x0b\x32&.envoy.service.ext_proc.v3.HeaderValue\x12V\n\rappend_action\x18\x03 \x01(\x0e\x32?.envoy.service.ext_proc.v3.HeaderValueOption.HeaderAppendAction\"}\n\x12HeaderAppendAction\x12\x1b\n\x17\x41PPEND_IF_EXISTS_OR_ADD\x10\x00\x12\x11\n\rADD_IF_ABSENT\x10\x01\x12\x1e\n\x1aOVERWRITE_IF_EXISTS_OR_ADD\x10\x02\x12\x17\n\x13OVERWRITE_IF_EXISTS\x10\x03\"D\n\tHeaderMap\x12\x37\n\x07headers\x18\x01 \x03(\x0b\x32&.envoy.service.ext_proc.v3.HeaderValue\"\x1a\n\nHttpStatus\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\"\xb0\x05\n\x0eProcessingMode\x12U\n\x13request_header_mode\x18\x01 \x01(\x0e\x32\x38.envoy.service.ext_proc.v3.ProcessingMode.HeaderSendMode\x12V\n\x14response_header_mode\x18\x02 \x01(\x0e\x32\x38.envoy.service.ext_proc.v3.ProcessingMode.HeaderSendMode\x12Q\n\x11request_body_mode\x18\x03 \x01(\x0e\x32\x36.envoy.service.ext_proc.v3.ProcessingMode.BodySendMode\x12R\n\x12response_body_mode\x18\x04 \x01(\x0e\x32\x36.envoy.service.ext_proc.v3.ProcessingMode.BodySendMode\x12V\n\x14request_trailer_mode\x18\x05 \x01(\x0e\x32\x38.envoy.service.ext_proc.v3.ProcessingMode.HeaderSendMode\x12W\n\x15response_trailer_mode\x18\x06 \x01(\x0e\x32\x38.envoy.service.ext_proc.v3.ProcessingMode.HeaderSendMode\"1\n\x0eHeaderSendMode\x12\x0b\n\x07\x44\x45\x46\x41ULT\x10\x00\x12\x08\n\x04SEND\x10\x01\x12\x08\n\x04SKIP\x10\x02\"d\n\x0c\x42odySendMode\x12\x08\n\x04NONE\x10\x00\x12\x0c\n\x08STREAMED\x10\x01\x12\x0c\n\x08\x42UFFERED\x10\x02\x12\x14\n\x10\x42UFFERED_PARTIAL\x10\x03\x12\x18\n\x14\x46ULL_DUPLEX_STREAMED\x10\x04\"[\n\x0bHttpHeaders\x12\x35\n\x07headers\x18\x01 \x01(\x0b\x32$.envoy.service.ext_proc.v3.HeaderMap\x12\x15\n\rend_of_stream\x18\x03 \x01(\x08\"/\n\x08HttpBody\x12\x0c\n\x04\x62ody\x18\x01 \x01(\x0c\x12\x15\n\rend_of_stream\x18\x02 \x01(\x08\"F\n\x0cHttpTrailers\x12\x36\n\x08trailers\x18\x01 \x01(\x0b\x32$.envoy.service.ext_proc.v3.HeaderMap\"\xcd\x03\n\x11ProcessingRequest\x12\x41\n\x0frequest_headers\x18\x02 \x01(\x0b\x32&.envoy.service.ext_proc.v3.HttpHeadersH\x00\x12\x42\n\x10response_headers\x18\x03 \x01(\x0b\x32&.envoy.service.ext_proc.v3.HttpHeadersH\x00\x12;\n\x0crequest_body\x18\x04 \x01(\x0b\x32#.envoy.service.ext_proc.v3.HttpBodyH\x00\x12<\n\rresponse_body\x18\x05 \x01(\x0b\x32#.envoy.service.ext_proc.v3.HttpBodyH\x00\x12\x43\n\x10request_trailers\x18\x06 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.HttpTrailersH\x00\x12\x44\n\x11response_trailers\x18\x07 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.HttpTrailersH\x00\x12\x1a\n\x12observability_mode\x18\n \x01(\x08\x42\t\n\x07requestJ\x04\x08\x01\x10\x02\"k\n\x0eHeaderMutation\x12\x41\n\x0bset_headers\x18\x01 \x03(\x0b\x32,.envoy.service.ext_proc.v3.HeaderValueOption\x12\x16\n\x0eremove_headers\x18\x02 \x03(\t\"@\n\x0c\x42odyMutation\x12\x0e\n\x04\x62ody\x18\x01 \x01(\x0cH\x00\x12\x14\n\nclear_body\x18\x02 \x01(\x08H\x00\x42\n\n\x08mutation\"\xeb\x02\n\x0e\x43ommonResponse\x12H\n\x06status\x18\x01 \x01(\x0e\x32\x38.envoy.service.ext_proc.v3.CommonResponse.ResponseStatus\x12\x42\n\x0fheader_mutation\x18\x02 \x01(\x0b\x32).envoy.service.ext_proc.v3.HeaderMutation\x12>\n\rbody_mutation\x18\x03 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.BodyMutation\x12\x36\n\x08trailers\x18\x04 \x01(\x0b\x32$.envoy.service.ext_proc.v3.HeaderMap\x12\x19\n\x11\x63lear_route_cache\x18\x05 \x01(\x08\"8\n\x0eResponseStatus\x12\x0c\n\x08\x43ONTINUE\x10\x00\x12\x18\n\x14\x43ONTINUE_AND_REPLACE\x10\x01\"N\n\x0fHeadersResponse\x12;\n\x08response\x18\x01 \x01(\x0b\x32).envoy.service.ext_proc.v3.CommonResponse\"K\n\x0c\x42odyResponse\x12;\n\x08response\x18\x01 \x01(\x0b\x32).envoy.service.ext_proc.v3.CommonResponse\"V\n\x10TrailersResponse\x12\x42\n\x0fheader_mutation\x18\x01 \x01(\x0b\x32).envoy.service.ext_proc.v3.HeaderMutation\"\xa5\x01\n\x11ImmediateResponse\x12\x35\n\x06status\x18\x01 \x01(\x0b\x32%.envoy.service.ext_proc.v3.HttpStatus\x12:\n\x07headers\x18\x02 \x01(\x0b\x32).envoy.service.ext_proc.v3.HeaderMutation\x12\x0c\n\x04\x62ody\x18\x03 \x01(\t\x12\x0f\n\x07\x64\x65tails\x18\x05 \x01(\t\"\xd3\x04\n\x12ProcessingResponse\x12\x45\n\x0frequest_headers\x18\x01 \x01(\x0b\x32*.envoy.service.ext_proc.v3.HeadersResponseH\x00\x12\x46\n\x10response_headers\x18\x02 \x01(\x0b\x32*.envoy.service.ext_proc.v3.HeadersResponseH\x00\x12?\n\x0crequest_body\x18\x03 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.BodyResponseH\x00\x12@\n\rresponse_body\x18\x04 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.BodyResponseH\x00\x12G\n\x10request_trailers\x18\x05 \x01(\x0b\x32+.envoy.service.ext_proc.v3.TrailersResponseH\x00\x12H\n\x11response_trailers\x18\x06 \x01(\x0b\x32+.envoy.service.ext_proc.v3.TrailersResponseH\x00\x12J\n\x12immediate_response\x18\x07 \x01(\x0b\x32,.envoy.service.ext_proc.v3.ImmediateResponseH\x00\x12@\n\rmode_override\x18\t \x01(\x0b\x32).envoy.service.ext_proc.v3.ProcessingModeB\n\n\x08response2\x7f\n\x11\x45xternalProcessor\x12j\n\x07Process\x12,.envoy.service.ext_proc.v3.ProcessingRequest\x1a-.envoy.service.ext_proc.v3.ProcessingResponse(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'external_processor_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEADERVALUE._serialized_start=55
  _HEADERVALUE._serialized_end=115
  _HEADERVALUEOPTION._serialized_start=118
  _HEADERVALUEOPTION._serialized_end=408
  _HEADERVALUEOPTION_HEADERAPPENDACTION._serialized_start=283
  _HEADERVALUEOPTION_HEADERAPPENDACTION._serialized_end=408
  _HEADERMAP._serialized_start=410
  _HEADERMAP._serialized_end=478
  _HTTPSTATUS._serialized_start=480
  _HTTPSTATUS._serialized_end=506
  _PROCESSINGMODE._serialized_start=509
  _PROCESSINGMODE._serialized_end=1197
  _PROCESSINGMODE_HEADERSENDMODE._serialized_start=1046
  _PROCESSINGMODE_HEADERSENDMODE._serialized_end=1095
  _PROCESSINGMODE_BODYSENDMODE._serialized_start=1097
  _PROCESSINGMODE_BODYSENDMODE._serialized_end=1197
  _HTTPHEADERS._serialized_start=1199
  _HTTPHEADERS._serialized_end=1290
  _HTTPBODY._serialized_start=1292
  _HTTPBODY._serialized_end=1339
  _HTTPTRAILERS._serialized_start=1341
  _HTTPTRAILERS._serialized_end=1411
  _PROCESSINGREQUEST._serialized_start=1414
  _PROCESSINGREQUEST._serialized_end=1875
  _HEADERMUTATION._serialized_start=1877
  _HEADERMUTATION._serialized_end=1984
  _BODYMUTATION._serialized_start=1986
  _BODYMUTATION._serialized_end=2050
  _COMMONRESPONSE._serialized_start=2053
  _COMMONRESPONSE._serialized_end=2416
  _COMMONRESPONSE_RESPONSESTATUS._serialized_start=2360
  _COMMONRESPONSE_RESPONSESTATUS._serialized_end=2416
  _HEADERSRESPONSE._serialized_start=2418
  _HEADERSRESPONSE._serialized_end=2496
  _BODYRESPONSE._serialized_start=2498
  _BODYRESPONSE._serialized_end=2573
  _TRAILERSRESPONSE._serialized_start=2575
  _TRAILERSRESPONSE._serialized_end=2661
  _IMMEDIATERESPONSE._serialized_start=2664
  _IMMEDIATERESPONSE._serialized_end=2829
  _PROCESSINGRESPONSE._serialized_start=2832
  _PROCESSINGRESPONSE._serialized_end=3427
  _EXTERNALPROCESSOR._serialized_start=3429
  _EXTERNALPROCESSOR._serialized_end=3556
# @@protoc_insertion_point(module_scope)
