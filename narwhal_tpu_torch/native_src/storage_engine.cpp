// Native storage engine: WAL-backed column-family byte store.
//
// Port copy of the JAX package's `native/storage_engine.cpp`, built by
// narwhal_tpu_torch/native.py into native_src/_build/. The equivalent of the
// reference's RocksDB C++ core behind typed-store (narwhal/storage/,
// node/src/lib.rs:53-123). On-disk format is IDENTICAL to the Python engine
// in narwhal_tpu_torch/storage.py (and the JAX package's) —
// records of <u32 payload_len><u32 crc32><body>, body =
//   <u32 op_count> { <u8 op><u16 cf_name_len><name><u32 klen><key>
//                    [<u32 vlen><value>  if op==0 (put)] }
// — so a store written by either engine reopens under the other.
//
// Exposed as a C ABI consumed through ctypes (narwhal_tpu_torch/native.py); the
// Python layer keeps column-family objects and the notify_read waiters, this
// layer owns the hash tables and the log.

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <zlib.h>

namespace {

struct Engine {
    std::string path;            // empty = memory-only
    FILE* log = nullptr;
    std::unordered_map<std::string, std::unordered_map<std::string, std::string>> cfs;
    uint64_t dirty_bytes = 0;
    uint64_t append_count = 0;
    std::string dump_buf;        // last nse_dump result

    std::string log_path() const { return path + "/wal.log"; }
};

uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86/ARM)
}

uint16_t rd_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

void wr_u32(std::string& out, uint32_t v) {
    out.append(reinterpret_cast<const char*>(&v), 4);
}

// Apply one record body to the tables. Returns false on malformed input.
bool apply_body(Engine* e, const uint8_t* body, size_t len) {
    if (len < 4) return false;
    size_t pos = 0;
    uint32_t count = rd_u32(body + pos);
    pos += 4;
    for (uint32_t i = 0; i < count; i++) {
        if (pos + 3 > len) return false;
        uint8_t op = body[pos];
        uint16_t nlen = rd_u16(body + pos + 1);
        pos += 3;
        if (pos + nlen + 4 > len) return false;
        std::string name(reinterpret_cast<const char*>(body + pos), nlen);
        pos += nlen;
        uint32_t klen = rd_u32(body + pos);
        pos += 4;
        if (pos + klen > len) return false;
        std::string key(reinterpret_cast<const char*>(body + pos), klen);
        pos += klen;
        auto& cf = e->cfs[name];
        if (op == 0) {
            if (pos + 4 > len) return false;
            uint32_t vlen = rd_u32(body + pos);
            pos += 4;
            if (pos + vlen > len) return false;
            cf[key].assign(reinterpret_cast<const char*>(body + pos), vlen);
            pos += vlen;
        } else {
            cf.erase(key);
        }
    }
    return pos == len;
}

void replay(Engine* e) {
    FILE* f = std::fopen(e->log_path().c_str(), "rb");
    if (!f) return;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> data(size > 0 ? size : 0);
    if (size > 0 && std::fread(data.data(), 1, size, f) != (size_t)size) {
        std::fclose(f);
        return;
    }
    std::fclose(f);
    size_t pos = 0, valid_end = 0;
    while (pos + 8 <= data.size()) {
        uint32_t plen = rd_u32(data.data() + pos);
        uint32_t crc = rd_u32(data.data() + pos + 4);
        size_t body_end = pos + 8 + plen;
        if (body_end > data.size()) break;
        const uint8_t* body = data.data() + pos + 8;
        if ((uint32_t)crc32(0, body, plen) != crc) break;
        if (!apply_body(e, body, plen)) break;
        pos = body_end;
        valid_end = pos;
    }
    if (valid_end < data.size()) {
        // torn tail: truncate to the last clean record boundary
        if (truncate(e->log_path().c_str(), (off_t)valid_end) != 0) {
            // best effort; appends still start from a clean in-memory state
        }
    }
}

uint64_t live_size(const Engine* e) {
    uint64_t total = 0;
    for (const auto& [name, cf] : e->cfs)
        for (const auto& [k, v] : cf) total += k.size() + v.size();
    return total;
}

void append_record(Engine* e, const uint8_t* body, uint32_t len) {
    if (!e->log) return;
    uint32_t crc = (uint32_t)crc32(0, body, len);
    std::fwrite(&len, 4, 1, e->log);
    std::fwrite(&crc, 4, 1, e->log);
    std::fwrite(body, 1, len, e->log);
    std::fflush(e->log);
    e->dirty_bytes += len;
    e->append_count += 1;
}

void compact(Engine* e) {
    if (!e->log) return;
    std::string tmp = e->log_path() + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return;
    for (const auto& [name, cf] : e->cfs) {
        for (const auto& [key, value] : cf) {
            std::string body;
            wr_u32(body, 1);
            body.push_back((char)0);
            uint16_t nlen = (uint16_t)name.size();
            body.append(reinterpret_cast<const char*>(&nlen), 2);
            body += name;
            wr_u32(body, (uint32_t)key.size());
            body += key;
            wr_u32(body, (uint32_t)value.size());
            body += value;
            uint32_t plen = (uint32_t)body.size();
            uint32_t crc = (uint32_t)crc32(
                0, reinterpret_cast<const uint8_t*>(body.data()), plen);
            std::fwrite(&plen, 4, 1, f);
            std::fwrite(&crc, 4, 1, f);
            std::fwrite(body.data(), 1, plen, f);
        }
    }
    std::fclose(f);
    std::fclose(e->log);
    std::rename(tmp.c_str(), e->log_path().c_str());
    e->log = std::fopen(e->log_path().c_str(), "ab");
    e->dirty_bytes = live_size(e);
}

}  // namespace

extern "C" {

void* nse_open(const char* path) {
    Engine* e = new Engine();
    if (path && path[0]) {
        e->path = path;
        replay(e);
        e->log = std::fopen(e->log_path().c_str(), "ab");
        if (!e->log) {
            delete e;
            return nullptr;
        }
    }
    return e;
}

// body uses the record-body format; applied to tables and appended to the WAL.
int nse_write_batch(void* h, const uint8_t* body, uint32_t len) {
    Engine* e = static_cast<Engine*>(h);
    if (!apply_body(e, body, len)) return -1;
    append_record(e, body, len);
    if (e->dirty_bytes > (64u << 20) && e->append_count % 4096 == 0 &&
        e->dirty_bytes > 2 * live_size(e)) {
        compact(e);
    }
    return 0;
}

// Returns 1 and sets (*val, *vlen) on hit; pointer valid until next mutation.
int nse_get(void* h, const char* cf, const uint8_t* key, uint32_t klen,
            const uint8_t** val, uint32_t* vlen) {
    Engine* e = static_cast<Engine*>(h);
    auto it = e->cfs.find(cf);
    if (it == e->cfs.end()) return 0;
    auto kit = it->second.find(std::string(reinterpret_cast<const char*>(key), klen));
    if (kit == it->second.end()) return 0;
    *val = reinterpret_cast<const uint8_t*>(kit->second.data());
    *vlen = (uint32_t)kit->second.size();
    return 1;
}

int nse_contains(void* h, const char* cf, const uint8_t* key, uint32_t klen) {
    Engine* e = static_cast<Engine*>(h);
    auto it = e->cfs.find(cf);
    if (it == e->cfs.end()) return 0;
    return it->second.count(std::string(reinterpret_cast<const char*>(key), klen))
               ? 1
               : 0;
}

uint64_t nse_len(void* h, const char* cf) {
    Engine* e = static_cast<Engine*>(h);
    auto it = e->cfs.find(cf);
    return it == e->cfs.end() ? 0 : it->second.size();
}

// Serialize a whole column family as { <u32 klen><key><u32 vlen><val> }*;
// returns the buffer (valid until the next nse_dump/nse_close) via out args.
void nse_dump(void* h, const char* cf, const uint8_t** buf, uint64_t* len) {
    Engine* e = static_cast<Engine*>(h);
    e->dump_buf.clear();
    auto it = e->cfs.find(cf);
    if (it != e->cfs.end()) {
        for (const auto& [key, value] : it->second) {
            wr_u32(e->dump_buf, (uint32_t)key.size());
            e->dump_buf += key;
            wr_u32(e->dump_buf, (uint32_t)value.size());
            e->dump_buf += value;
        }
    }
    *buf = reinterpret_cast<const uint8_t*>(e->dump_buf.data());
    *len = e->dump_buf.size();
}

void nse_compact(void* h) { compact(static_cast<Engine*>(h)); }

// Close only the WAL: tables stay readable (parity with the Python engine,
// whose close() stops appends but keeps serving reads).
void nse_close_log(void* h) {
    Engine* e = static_cast<Engine*>(h);
    if (e->log) {
        std::fclose(e->log);
        e->log = nullptr;
    }
}

void nse_close(void* h) {
    Engine* e = static_cast<Engine*>(h);
    if (e->log) std::fclose(e->log);
    delete e;
}

}  // extern "C"
