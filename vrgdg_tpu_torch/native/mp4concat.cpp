// mp4concat — lossless MP4 segment concatenation by stream copy.
//
// The reference joins enhancer segments with ffmpeg's concat demuxer in
// stream-copy mode (VRGDG_StandaloneVideoEnhancerNodes.py:444-510). When no ffmpeg binary is present this framework previously
// fell back to a full cv2 re-encode (minutes of single-core 4K x264/mp4v
// work and a generation loss). This native component restores the
// stream-copy path without ffmpeg: it parses each segment's sample
// tables, copies the sample payloads byte-identically into one mdat, and
// rebuilds the moov from the first segment's as a template with merged
// stts/stss/stsc/stsz/stco(+co64) tables and patched durations.
//
// Scope (checked, with clear errors): single-video-track MP4s that share
// one sample description (same codec/dims/writer) — exactly what the
// framework's own VideoWriter produces for every segment of a job.
//
// C ABI only; loaded from Python via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string message;
  bool ok() const { return message.empty(); }
};

uint32_t read_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint64_t read_u64(const uint8_t* p) {
  return (uint64_t(read_u32(p)) << 32) | read_u32(p + 4);
}

void write_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

void write_u64(std::vector<uint8_t>& out, uint64_t v) {
  write_u32(out, uint32_t(v >> 32));
  write_u32(out, uint32_t(v));
}

bool is_container(const char* t) {
  static const char* kContainers[] = {"moov", "trak", "mdia", "minf",
                                      "stbl", "edts", "dinf"};
  for (const char* c : kContainers)
    if (std::memcmp(t, c, 4) == 0) return true;
  return false;
}

// In-memory box tree. Leaf boxes keep their payload verbatim; containers
// keep children. Serialization recomputes every box size, so table edits
// propagate to ancestors for free.
struct Box {
  char type[4];
  std::vector<uint8_t> payload;  // leaf payload (without header)
  std::vector<Box> children;     // container children
  bool container = false;

  bool is(const char* t) const { return std::memcmp(type, t, 4) == 0; }

  Box* find(const char* t) {
    for (auto& c : children)
      if (c.is(t)) return &c;
    return nullptr;
  }

  void remove(const char* t) {
    for (size_t i = 0; i < children.size(); ++i)
      if (children[i].is(t)) {
        children.erase(children.begin() + long(i));
        return;
      }
  }

  void serialize(std::vector<uint8_t>& out) const {
    size_t size_at = out.size();
    write_u32(out, 0);  // patched below
    out.insert(out.end(), type, type + 4);
    if (container) {
      for (const auto& c : children) c.serialize(out);
    } else {
      out.insert(out.end(), payload.begin(), payload.end());
    }
    uint64_t size = out.size() - size_at;
    if (size > 0xFFFFFFFFull) return;  // moov never approaches 4 GB
    out[size_at] = uint8_t(size >> 24);
    out[size_at + 1] = uint8_t(size >> 16);
    out[size_at + 2] = uint8_t(size >> 8);
    out[size_at + 3] = uint8_t(size);
  }
};

Error parse_children(const uint8_t* data, uint64_t size,
                     std::vector<Box>& out) {
  uint64_t off = 0;
  while (off < size) {
    if (off + 8 > size) return {"truncated box header"};
    uint64_t box_size = read_u32(data + off);
    uint64_t header = 8;
    if (box_size == 1) {
      if (off + 16 > size) return {"truncated 64-bit box header"};
      box_size = read_u64(data + off + 8);
      header = 16;
    } else if (box_size == 0) {
      box_size = size - off;
    }
    if (box_size < header || off + box_size > size)
      return {"box overruns its parent"};
    Box box;
    std::memcpy(box.type, data + off + 4, 4);
    box.container = is_container(box.type);
    if (box.container) {
      Error err = parse_children(data + off + header, box_size - header,
                                 box.children);
      if (!err.ok()) return err;
    } else {
      box.payload.assign(data + off + header, data + off + box_size);
    }
    out.push_back(std::move(box));
    off += box_size;
  }
  return {};
}

struct SttsEntry {
  uint32_t count;
  uint32_t delta;
};

// Everything needed from one segment to stream-copy its samples.
struct Segment {
  std::vector<uint8_t> moov;          // raw moov payload
  std::vector<uint64_t> offsets;      // per-sample file offset
  std::vector<uint32_t> sizes;        // per-sample byte size
  std::vector<SttsEntry> stts;
  std::vector<uint32_t> sync;         // 1-based keyframe sample numbers
  std::vector<uint8_t> stsd;          // payload, compared across segments
  uint64_t media_duration = 0;        // in mdhd timescale units
  uint32_t media_timescale = 0;
  std::string path;
};

// Zero the per-file bitrate fields inside an stsd payload so segments
// from the same writer/job compare equal: the btrt box payload and the
// bufferSizeDB/maxBitrate/avgBitrate of the esds DecoderConfigDescriptor
// (tag 0x04). Codec config (DecoderSpecificInfo, dims, fourcc) stays in
// the comparison. Best-effort: on any structural surprise the payload is
// left untouched and the strict comparison applies.
void normalize_stsd(std::vector<uint8_t>& stsd) {
  // stsd payload: version/flags(4) entry_count(4), then sample entries.
  if (stsd.size() < 16 || read_u32(stsd.data() + 4) != 1) return;
  size_t entry = 8;
  uint64_t entry_size = read_u32(stsd.data() + entry);
  if (entry_size < 94 || entry + entry_size > stsd.size()) return;
  // Visual sample entry: 8 box header + 8 SampleEntry fields + 70 video
  // fields, then child boxes.
  size_t off = entry + 86;
  size_t end = entry + entry_size;
  while (off + 8 <= end) {
    uint32_t box_size = read_u32(stsd.data() + off);
    if (box_size < 8 || off + box_size > end) return;
    const uint8_t* type = stsd.data() + off + 4;
    if (std::memcmp(type, "btrt", 4) == 0) {
      std::memset(stsd.data() + off + 8, 0, box_size - 8);
    } else if (std::memcmp(type, "esds", 4) == 0 && box_size > 12) {
      // esds: version/flags(4) then an MPEG-4 descriptor chain with
      // 0x80-extended varint lengths. Self-contained block: any
      // structural surprise abandons the normalization for this box
      // only — control must always reach the `off += box_size` below
      // (a `continue` here once looped forever on a malformed chain).
      [&] {
        size_t p = off + 8 + 4;
        auto read_descriptor = [&](uint8_t expect_tag,
                                   size_t* len) -> bool {
          if (p >= end || stsd[p] != expect_tag) return false;
          ++p;
          uint64_t value = 0;
          for (int i = 0; i < 4 && p < end; ++i) {
            uint8_t byte = stsd[p++];
            value = (value << 7) | (byte & 0x7F);
            if (!(byte & 0x80)) break;
          }
          *len = size_t(value);
          return true;
        };
        size_t len;
        if (!read_descriptor(0x03, &len)) return;
        if (p + 3 > end) return;
        uint8_t es_flags = stsd[p + 2];
        p += 3;                              // ES_ID(2) + flags(1)
        if (es_flags & 0x80) p += 2;         // streamDependence
        if (es_flags & 0x40 && p < end) p += 1 + stsd[p];  // URL
        if (es_flags & 0x20) p += 2;         // OCR
        if (!read_descriptor(0x04, &len)) return;
        // DecoderConfigDescriptor: objectType(1) streamType(1)
        // bufferSizeDB(3) maxBitrate(4) avgBitrate(4) ...
        if (len >= 13 && p + 13 <= end)
          std::memset(stsd.data() + p + 2, 0, 11);
      }();
    }
    off += box_size;
  }
}

Error table_header(const Box* box, const char* name, uint32_t* count,
                   const uint8_t** rows, size_t row_bytes) {
  if (!box) return {std::string("missing ") + name};
  if (box->payload.size() < 8) return {std::string("short ") + name};
  *count = read_u32(box->payload.data() + 4);
  if (box->payload.size() < 8 + row_bytes * uint64_t(*count))
    return {std::string("truncated ") + name};
  *rows = box->payload.data() + 8;
  return {};
}

Error load_segment(const char* path, Segment& seg) {
  seg.path = path;
  FILE* f = std::fopen(path, "rb");
  if (!f) return {std::string("cannot open ") + path};
  uint64_t file_size = 0;
  if (std::fseek(f, 0, SEEK_END) == 0) {
    long at_end = std::ftell(f);
    if (at_end > 0) file_size = uint64_t(at_end);
  }
  std::fseek(f, 0, SEEK_SET);
  // Walk top-level boxes to find moov (usually last; mdat is skipped).
  uint8_t header[16];
  uint64_t offset = 0;
  bool found = false;
  for (;;) {
    if (std::fseek(f, long(offset), SEEK_SET) != 0) break;
    if (std::fread(header, 1, 8, f) != 8) break;
    uint64_t size = read_u32(header);
    uint64_t hdr = 8;
    if (size == 1) {
      if (std::fread(header + 8, 1, 8, f) != 8) break;
      size = read_u64(header + 8);
      hdr = 16;
    }
    if (size < hdr) break;
    if (std::memcmp(header + 4, "moov", 4) == 0) {
      if (size - hdr > file_size) {  // corrupted size field: don't
        break;                       // allocate gigabytes on faith
      }
      seg.moov.resize(size - hdr);
      if (std::fread(seg.moov.data(), 1, seg.moov.size(), f) !=
          seg.moov.size()) {
        std::fclose(f);
        return {std::string("truncated moov in ") + path};
      }
      found = true;
      break;
    }
    offset += size;
  }
  std::fclose(f);
  if (!found) return {std::string("no moov box in ") + path};

  std::vector<Box> tree;
  Error err = parse_children(seg.moov.data(), seg.moov.size(), tree);
  if (!err.ok()) return {err.message + " in " + path};
  Box root;
  std::memcpy(root.type, "moov", 4);
  root.container = true;
  root.children = std::move(tree);

  int traks = 0;
  for (auto& c : root.children)
    if (c.is("trak")) ++traks;
  if (traks != 1)
    return {path + std::string(": expected exactly 1 track, found ") +
            std::to_string(traks)};

  Box* trak = root.find("trak");
  Box* mdia = trak ? trak->find("mdia") : nullptr;
  Box* minf = mdia ? mdia->find("minf") : nullptr;
  Box* stbl = minf ? minf->find("stbl") : nullptr;
  if (!stbl) return {std::string("no stbl in ") + path};

  Box* mdhd = mdia->find("mdhd");
  if (!mdhd || mdhd->payload.size() < 4)
    return {std::string("no mdhd in ") + path};
  uint8_t version = mdhd->payload[0];
  if (version == 0) {
    if (mdhd->payload.size() < 24) return {std::string("short mdhd")};
    seg.media_timescale = read_u32(mdhd->payload.data() + 12);
    seg.media_duration = read_u32(mdhd->payload.data() + 16);
  } else {
    if (mdhd->payload.size() < 32) return {std::string("short mdhd v1")};
    seg.media_timescale = read_u32(mdhd->payload.data() + 20);
    seg.media_duration = read_u64(mdhd->payload.data() + 24);
  }

  // Composition offsets (B-frame reordering) would need a merged ctts;
  // this framework's own writers never emit one, so reject instead of
  // producing a file whose ctts covers only the first segment.
  if (stbl->find("ctts"))
    return {path + std::string(": composition offsets (ctts / B-frame "
                               "reordering) are not supported")};

  Box* stsd = stbl->find("stsd");
  if (!stsd) return {std::string("no stsd in ") + path};
  seg.stsd = stsd->payload;
  normalize_stsd(seg.stsd);  // ignore per-file bitrate hint fields

  // stts: decoding deltas
  uint32_t n;
  const uint8_t* rows;
  err = table_header(stbl->find("stts"), "stts", &n, &rows, 8);
  if (!err.ok()) return {err.message + " in " + path};
  uint64_t stts_duration = 0;
  for (uint32_t i = 0; i < n; ++i) {
    seg.stts.push_back({read_u32(rows + 8 * i), read_u32(rows + 8 * i + 4)});
    stts_duration += uint64_t(seg.stts.back().count) * seg.stts.back().delta;
  }
  // stts is the ground truth for media duration; some writers leave the
  // mdhd duration zero or stale.
  if (stts_duration > 0) seg.media_duration = stts_duration;

  // stsz: sample sizes (uniform or table)
  Box* stsz = stbl->find("stsz");
  if (!stsz || stsz->payload.size() < 12)
    return {std::string("missing/short stsz in ") + path};
  uint32_t uniform = read_u32(stsz->payload.data() + 4);
  uint32_t sample_count = read_u32(stsz->payload.data() + 8);
  // Sanity: claimed sample payload cannot exceed the file itself — a
  // corrupted count would otherwise drive multi-gigabyte allocations
  // and near-endless offset loops before the copy phase errors out.
  if (uniform != 0 &&
      uint64_t(sample_count) * uniform > file_size)
    return {std::string("stsz claims more sample bytes than the file "
                        "holds in ") + path};
  if (uniform != 0) {
    seg.sizes.assign(sample_count, uniform);
  } else {
    if (stsz->payload.size() < 12 + 4ull * sample_count)
      return {std::string("truncated stsz in ") + path};
    for (uint32_t i = 0; i < sample_count; ++i)
      seg.sizes.push_back(read_u32(stsz->payload.data() + 12 + 4 * i));
  }

  // chunk offsets: stco (32-bit) or co64
  std::vector<uint64_t> chunk_offsets;
  if (Box* stco = stbl->find("stco")) {
    err = table_header(stco, "stco", &n, &rows, 4);
    if (!err.ok()) return {err.message + " in " + path};
    for (uint32_t i = 0; i < n; ++i)
      chunk_offsets.push_back(read_u32(rows + 4 * i));
  } else if (Box* co64 = stbl->find("co64")) {
    err = table_header(co64, "co64", &n, &rows, 8);
    if (!err.ok()) return {err.message + " in " + path};
    for (uint32_t i = 0; i < n; ++i)
      chunk_offsets.push_back(read_u64(rows + 8 * i));
  } else {
    return {std::string("no stco/co64 in ") + path};
  }

  // stsc: sample-to-chunk runs -> per-sample file offsets
  err = table_header(stbl->find("stsc"), "stsc", &n, &rows, 12);
  if (!err.ok()) return {err.message + " in " + path};
  struct StscEntry {
    uint32_t first_chunk, samples_per_chunk;
  };
  std::vector<StscEntry> stsc;
  for (uint32_t i = 0; i < n; ++i)
    stsc.push_back({read_u32(rows + 12 * i), read_u32(rows + 12 * i + 4)});
  seg.offsets.reserve(sample_count);
  uint32_t sample = 0;
  for (size_t run = 0; run < stsc.size() && sample < sample_count; ++run) {
    uint32_t first = stsc[run].first_chunk;  // 1-based
    uint32_t last = (run + 1 < stsc.size()) ? stsc[run + 1].first_chunk
                                            : uint32_t(chunk_offsets.size() + 1);
    for (uint32_t chunk = first; chunk < last && sample < sample_count;
         ++chunk) {
      if (chunk == 0 || chunk > chunk_offsets.size())
        return {std::string("stsc points past stco in ") + path};
      uint64_t pos = chunk_offsets[chunk - 1];
      for (uint32_t s = 0;
           s < stsc[run].samples_per_chunk && sample < sample_count; ++s) {
        seg.offsets.push_back(pos);
        pos += seg.sizes[sample];
        ++sample;
      }
    }
  }
  if (sample != sample_count)
    return {std::string("sample tables inconsistent in ") + path};
  for (uint32_t i = 0; i < sample_count; ++i)
    if (seg.offsets[i] + seg.sizes[i] > file_size)
      return {std::string("sample extends past end of file in ") + path};

  // stss: sync samples (optional; absent means all samples sync)
  if (Box* stss = stbl->find("stss")) {
    err = table_header(stss, "stss", &n, &rows, 4);
    if (!err.ok()) return {err.message + " in " + path};
    for (uint32_t i = 0; i < n; ++i)
      seg.sync.push_back(read_u32(rows + 4 * i));
  }
  return {};
}

std::vector<uint8_t> full_box(uint32_t version_flags) {
  std::vector<uint8_t> payload;
  write_u32(payload, version_flags);
  return payload;
}

// Patch a duration field inside mvhd/tkhd/mdhd, handling version 0/1.
Error patch_duration(Box* box, const char* name, uint64_t duration,
                     size_t v0_offset, size_t v1_offset) {
  if (!box || box->payload.empty())
    return {std::string("missing ") + name + " in template"};
  uint8_t version = box->payload[0];
  size_t at = version == 0 ? v0_offset : v1_offset;
  size_t width = version == 0 ? 4 : 8;
  if (box->payload.size() < at + width)
    return {std::string("short ") + name + " in template"};
  if (version == 0) {
    if (duration > 0xFFFFFFFFull) return {"duration overflows 32-bit box"};
    box->payload[at] = uint8_t(duration >> 24);
    box->payload[at + 1] = uint8_t(duration >> 16);
    box->payload[at + 2] = uint8_t(duration >> 8);
    box->payload[at + 3] = uint8_t(duration);
  } else {
    for (int i = 0; i < 8; ++i)
      box->payload[at + i] = uint8_t(duration >> (8 * (7 - i)));
  }
  return {};
}

Error concat(const char* const* inputs, int32_t n_inputs,
             const char* output) {
  if (n_inputs < 1) return {"need at least one input"};
  std::vector<Segment> segments(static_cast<size_t>(n_inputs));
  for (int32_t i = 0; i < n_inputs; ++i) {
    Error err = load_segment(inputs[i], segments[size_t(i)]);
    if (!err.ok()) return err;
    if (i > 0) {
      if (segments[size_t(i)].stsd != segments[0].stsd)
        return {segments[size_t(i)].path +
                ": sample description differs from first segment "
                "(codec/dims mismatch)"};
      if (segments[size_t(i)].media_timescale != segments[0].media_timescale)
        return {segments[size_t(i)].path + ": timescale mismatch"};
    }
  }

  // Merged tables.
  uint64_t total_samples = 0, total_payload = 0, total_duration = 0;
  for (const auto& seg : segments) {
    total_samples += seg.sizes.size();
    for (uint32_t s : seg.sizes) total_payload += s;
    total_duration += seg.media_duration;
  }
  if (total_samples == 0) return {"no samples across inputs"};

  std::vector<SttsEntry> stts;
  for (const auto& seg : segments)
    for (const auto& entry : seg.stts) {
      if (!stts.empty() && stts.back().delta == entry.delta)
        stts.back().count += entry.count;
      else
        stts.push_back(entry);
    }

  // A missing stss means every sample is a sync sample (ISO 14496-12
  // §8.6.2) — encoders omit it for all-keyframe segments. Merge
  // accordingly: only emit stss if at least one input restricts sync
  // samples, and expand stss-less inputs to all-sync in that case.
  std::vector<uint32_t> sync;
  bool any_stss = false;
  for (const auto& seg : segments) any_stss |= !seg.sync.empty();
  if (any_stss) {
    uint64_t base = 0;
    for (const auto& seg : segments) {
      if (seg.sync.empty()) {
        for (uint32_t s = 1; s <= seg.sizes.size(); ++s)
          sync.push_back(uint32_t(base + s));
      } else {
        for (uint32_t s : seg.sync) sync.push_back(uint32_t(base + s));
      }
      base += seg.sizes.size();
    }
  }

  // Rebuild the first segment's moov with the merged tables. One chunk
  // per input segment: samples land contiguously in the output mdat.
  std::vector<Box> tree;
  Error err =
      parse_children(segments[0].moov.data(), segments[0].moov.size(), tree);
  if (!err.ok()) return err;
  Box moov;
  std::memcpy(moov.type, "moov", 4);
  moov.container = true;
  moov.children = std::move(tree);
  Box* trak = moov.find("trak");
  Box* mdia = trak ? trak->find("mdia") : nullptr;
  Box* minf = mdia ? mdia->find("minf") : nullptr;
  Box* stbl = minf ? minf->find("stbl") : nullptr;
  if (!stbl) return {"template moov lost its stbl"};

  // Durations (media units for mdhd; movie-timescale units for
  // mvhd/tkhd, converted via the two timescales).
  Box* mvhd = moov.find("mvhd");
  if (!mvhd || mvhd->payload.size() < 16) return {"missing mvhd"};
  uint32_t movie_timescale =
      mvhd->payload[0] == 0 ? read_u32(mvhd->payload.data() + 12)
                            : read_u32(mvhd->payload.data() + 20);
  uint64_t movie_duration =
      segments[0].media_timescale == 0
          ? 0
          : total_duration * movie_timescale / segments[0].media_timescale;
  err = patch_duration(mvhd, "mvhd", movie_duration, 16, 24);
  if (!err.ok()) return err;
  err = patch_duration(trak->find("tkhd"), "tkhd", movie_duration, 20, 28);
  if (!err.ok()) return err;
  err = patch_duration(mdia->find("mdhd"), "mdhd", total_duration, 16, 24);
  if (!err.ok()) return err;
  // An edit list would re-time the merged track; segments are played
  // back-to-back, so drop it (it is optional and cv2/ffmpeg write a
  // zero-offset one). Likewise drop any per-sample auxiliary tables the
  // template might carry — they would describe only segment 1's samples
  // (ctts-bearing inputs are rejected above; these are optional hints).
  trak->remove("edts");
  // Multiple sbgp/sgpd boxes (one per grouping_type) are legal: remove
  // every instance, not just the first.
  for (const char* aux : {"sdtp", "sbgp", "sgpd", "ctts"})
    while (stbl->find(aux)) stbl->remove(aux);

  auto replace_table = [&](const char* type, std::vector<uint8_t> payload) {
    Box* box = stbl->find(type);
    if (box) {
      box->payload = std::move(payload);
    } else {
      Box fresh;
      std::memcpy(fresh.type, type, 4);
      fresh.payload = std::move(payload);
      stbl->children.push_back(std::move(fresh));
    }
  };

  {
    std::vector<uint8_t> payload = full_box(0);
    write_u32(payload, uint32_t(stts.size()));
    for (const auto& entry : stts) {
      write_u32(payload, entry.count);
      write_u32(payload, entry.delta);
    }
    replace_table("stts", std::move(payload));
  }
  if (!sync.empty()) {
    std::vector<uint8_t> payload = full_box(0);
    write_u32(payload, uint32_t(sync.size()));
    for (uint32_t s : sync) write_u32(payload, s);
    replace_table("stss", std::move(payload));
  } else {
    stbl->remove("stss");
  }
  {
    std::vector<uint8_t> payload = full_box(0);
    write_u32(payload, uint32_t(segments.size()));
    for (size_t i = 0; i < segments.size(); ++i) {
      write_u32(payload, uint32_t(i + 1));  // first_chunk (1-based)
      write_u32(payload, uint32_t(segments[i].sizes.size()));
      write_u32(payload, 1);  // sample description id
    }
    replace_table("stsc", std::move(payload));
  }
  {
    std::vector<uint8_t> payload = full_box(0);
    write_u32(payload, 0);  // not uniform
    write_u32(payload, uint32_t(total_samples));
    for (const auto& seg : segments)
      for (uint32_t s : seg.sizes) write_u32(payload, s);
    replace_table("stsz", std::move(payload));
  }

  // mdat layout: ftyp | mdat | moov. Chunk offsets need the mdat data
  // start, known once we pick the mdat header width.
  const std::vector<uint8_t>* ftyp_payload = nullptr;
  std::vector<uint8_t> ftyp;
  {
    // Re-read just the ftyp of the first input.
    FILE* f = std::fopen(inputs[0], "rb");
    if (!f) return {std::string("cannot reopen ") + inputs[0]};
    uint8_t hdr[8];
    if (std::fread(hdr, 1, 8, f) == 8 && std::memcmp(hdr + 4, "ftyp", 4) == 0) {
      uint32_t size = read_u32(hdr);
      if (size >= 8 && size <= 4096) {
        ftyp.resize(size - 8);
        if (std::fread(ftyp.data(), 1, ftyp.size(), f) == ftyp.size())
          ftyp_payload = &ftyp;
      }
    }
    std::fclose(f);
  }

  bool big_mdat = total_payload + 16 > 0xFFFFFFFFull;
  uint64_t ftyp_size = ftyp_payload ? ftyp_payload->size() + 8 : 0;
  uint64_t mdat_header = big_mdat ? 16 : 8;
  uint64_t data_start = ftyp_size + mdat_header;

  // Chunk offsets (one chunk per segment) in the output file.
  bool use_co64 = data_start + total_payload > 0xFFFFFFFFull;
  {
    std::vector<uint8_t> payload = full_box(0);
    write_u32(payload, uint32_t(segments.size()));
    uint64_t pos = data_start;
    for (const auto& seg : segments) {
      if (use_co64)
        write_u64(payload, pos);
      else
        write_u32(payload, uint32_t(pos));
      for (uint32_t s : seg.sizes) pos += s;
    }
    stbl->remove("stco");
    stbl->remove("co64");
    replace_table(use_co64 ? "co64" : "stco", std::move(payload));
  }

  // Serialize moov, then write the file: ftyp, mdat (streamed), moov.
  std::vector<uint8_t> moov_bytes;
  moov.serialize(moov_bytes);

  FILE* out = std::fopen(output, "wb");
  if (!out) return {std::string("cannot create ") + output};
  auto fail = [&](std::string why) {
    std::fclose(out);
    std::remove(output);
    return Error{why};
  };
  if (ftyp_payload) {
    std::vector<uint8_t> hdr;
    write_u32(hdr, uint32_t(ftyp_payload->size() + 8));
    hdr.insert(hdr.end(), {'f', 't', 'y', 'p'});
    if (std::fwrite(hdr.data(), 1, hdr.size(), out) != hdr.size() ||
        std::fwrite(ftyp_payload->data(), 1, ftyp_payload->size(), out) !=
            ftyp_payload->size())
      return fail("write failed (ftyp)");
  }
  {
    std::vector<uint8_t> hdr;
    if (big_mdat) {
      write_u32(hdr, 1);
      hdr.insert(hdr.end(), {'m', 'd', 'a', 't'});
      write_u64(hdr, total_payload + 16);
    } else {
      write_u32(hdr, uint32_t(total_payload + 8));
      hdr.insert(hdr.end(), {'m', 'd', 'a', 't'});
    }
    if (std::fwrite(hdr.data(), 1, hdr.size(), out) != hdr.size())
      return fail("write failed (mdat header)");
  }
  std::vector<uint8_t> buffer(1 << 20);
  for (const auto& seg : segments) {
    FILE* in = std::fopen(seg.path.c_str(), "rb");
    if (!in) return fail("cannot reopen " + seg.path);
    for (size_t i = 0; i < seg.sizes.size(); ++i) {
      if (std::fseek(in, long(seg.offsets[i]), SEEK_SET) != 0) {
        std::fclose(in);
        return fail("seek failed in " + seg.path);
      }
      uint64_t remaining = seg.sizes[i];
      while (remaining > 0) {
        size_t take = size_t(remaining < buffer.size() ? remaining
                                                       : buffer.size());
        if (std::fread(buffer.data(), 1, take, in) != take) {
          std::fclose(in);
          return fail("sample read failed in " + seg.path);
        }
        if (std::fwrite(buffer.data(), 1, take, out) != take) {
          std::fclose(in);
          return fail("write failed (mdat)");
        }
        remaining -= take;
      }
    }
    std::fclose(in);
  }
  if (std::fwrite(moov_bytes.data(), 1, moov_bytes.size(), out) !=
      moov_bytes.size())
    return fail("write failed (moov)");
  if (std::fclose(out) != 0) {
    std::remove(output);
    return {"close failed"};
  }
  return {};
}

}  // namespace

extern "C" int mp4_concat(const char* const* inputs, int32_t n_inputs,
                          const char* output, char* errbuf,
                          int32_t errlen) {
  Error err;
  try {
    err = concat(inputs, n_inputs, output);
  } catch (const std::exception& exc) {
    // Never let bad_alloc etc. escape the C ABI into the Python host.
    err.message = std::string("mp4 concat internal error: ") + exc.what();
  } catch (...) {
    err.message = "mp4 concat internal error";
  }
  if (err.ok()) return 0;
  if (errbuf && errlen > 0) {
    std::snprintf(errbuf, size_t(errlen), "%s", err.message.c_str());
  }
  return 1;
}
